"""Two of the presets written as Mitsuba XML, for `loader.load_file`: the
Cornell box (`presets.cornell_box`'s walls, boxes and light as rectangles
and cubes under <transform>s, its area light, camera and depth-7 path
tracer) and the grating scene (`presets.grating_scene`'s floor, slab,
directional and constant lights and camera, the roughgrating written
with the preset's parameters, and PLT). Their transforms compose in
float32 as the XML loader composes them, where the presets compose in
float64, so the loaded scenes differ from the presets by rounding; and the
XML's own defaults fill what the file does not say (a roughgrating's
specular_reflectance is 1). The film's size is $resx x $resy."""
from __future__ import annotations

import numpy as np

from . import presets as ps


def _v(xs):
    return ", ".join(repr(float(x)) for x in xs)


def _rgb(name, xs):
    return f'<rgb name="{name}" value="{_v(xs)}"/>'


def _transform(translate=None, rotate=None, scale=None):
    """A <transform name="to_world"> applying scale, then rotate (axis,
    degrees), then translate."""
    out = ['<transform name="to_world">']
    if scale is not None:
        out.append(f'<scale x="{scale[0]!r}" y="{scale[1]!r}" '
                   f'z="{scale[2]!r}"/>')
    if rotate is not None:
        (x, y, z), angle = rotate
        out.append(f'<rotate x="{x}" y="{y}" z="{z}" angle="{angle!r}"/>')
    if translate is not None:
        out.append(f'<translate x="{translate[0]!r}" y="{translate[1]!r}" '
                   f'z="{translate[2]!r}"/>')
    return "\n      ".join(out) + "\n    </transform>"


def _sensor(origin, target, fov, spp, rfilter=None):
    rf = f'\n      <rfilter type="{rfilter}"/>' if rfilter else ""
    return f"""  <sensor type="perspective">
    <float name="fov" value="{fov!r}"/>
    <transform name="to_world">
      <lookat origin="{_v(origin)}" target="{_v(target)}" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sample_count" value="{spp}"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$resx"/>
      <integer name="height" value="$resy"/>{rf}
    </film>
  </sensor>"""


def cornell_box_xml(width: int = 512, height: int = 512, spp: int = 8,
                    max_depth: int = 7, rr_depth: int = 50,
                    rfilter: str | None = None) -> str:
    """The Cornell box (diffuse boxes) as XML: a path tracer of
    `max_depth` / `rr_depth`, `spp` samples, the film's default gaussian
    filter unless `rfilter` names another."""
    colours = {"white": (0.885809, 0.698859, 0.666422),
               "green": (0.105421, 0.37798, 0.076425),
               "red": (0.570068, 0.0430135, 0.0443706),
               "box": ps.BOX_MATERIALS["diffuse"][1]["base_color"]}
    bsdfs = "\n".join(
        f'  <bsdf type="diffuse" id="{k}">{_rgb("reflectance", c)}</bsdf>'
        for k, c in colours.items())
    X, Y = (1, 0, 0), (0, 1, 0)
    shapes = [  # (type, bsdf, translate, rotate, scale)
        ("rectangle", "white", (0, -1, 0), (X, -90.0), None),   # floor
        ("rectangle", "white", (0, 1, 0), (X, 90.0), None),     # ceiling
        ("rectangle", "white", (0, 0, -1), None, None),         # back
        ("rectangle", "green", (1, 0, 0), (Y, -90.0), None),
        ("rectangle", "red", (-1, 0, 0), (Y, 90.0), None),
        ("cube", "box", (0.335, -0.7, 0.38), (Y, -17.0),
         (0.25, 0.3, 0.25)),
        ("cube", "box", (-0.33, -0.4, -0.28), (Y, 18.25),
         (0.25, 0.6, 0.25)),
    ]
    body = []
    for stype, bsdf, t, r, s in shapes:
        body.append(f"""  <shape type="{stype}">
    {_transform(t, r, s)}
    <ref id="{bsdf}"/>
  </shape>""")
    light = (18.387, 13.9873, 6.75357)
    body.append(f"""  <shape type="rectangle">
    {_transform((0, 0.99, 0.01), (X, 90.0), (0.23, 0.19, 1.0))}
    <ref id="white"/>
    <emitter type="area">{_rgb("radiance", light)}</emitter>
  </shape>""")
    return f"""<scene version="3.0.0">
  <default name="resx" value="{width}"/>
  <default name="resy" value="{height}"/>
  <integrator type="path">
    <integer name="max_depth" value="{max_depth}"/>
    <integer name="rr_depth" value="{rr_depth}"/>
  </integrator>
{_sensor((0, 0, 3.9), (0, 0, 0), 39.3077, spp, rfilter)}
{bsdfs}
{chr(10).join(body)}
</scene>
"""


def grating_scene_xml(width: int = 800, height: int = 600, spp: int = 4,
                      max_depth: int = 7, rr_depth: int = 50,
                      light_angle_deg: float = -15.0) -> str:
    """The grating scene as XML at `presets.grating_scene`'s defaults
    (sinusoidal, height 0.04 um, inv_period 0.6/um, 7 lobes, alpha 0.04,
    multiplier 10, coherence 6e5), PLT of `max_depth` / `rr_depth`, the
    box filter."""
    th = np.deg2rad(light_angle_deg)
    d = (np.sin(th), -np.cos(th), 0.0)
    spec = np.array([-np.sin(th), np.cos(th), 0.0])
    cam = np.array([0.0, -0.5, 0.0]) + 2.2 * spec + np.array([0, 0, 0.35])
    X = (1, 0, 0)
    return f"""<scene version="3.0.0">
  <default name="resx" value="{width}"/>
  <default name="resy" value="{height}"/>
  <integrator type="plt">
    <integer name="max_depth" value="{max_depth}"/>
    <integer name="rr_depth" value="{rr_depth}"/>
  </integrator>
{_sensor(cam, (0, -0.5, 0), 45.0, spp, "box")}
  <bsdf type="diffuse" id="floor">{_rgb("reflectance", (0.1, 0.1, 0.1))}</bsdf>
  <bsdf type="roughgrating" id="grating">
    {_rgb("eta", (0.2, 0.92, 1.1))}
    {_rgb("k", (3.9, 2.45, 2.14))}
    <float name="alpha" value="0.04"/>
    <float name="inv_period" value="0.6"/>
    <float name="height" value="0.04"/>
    <integer name="lobes" value="7"/>
    <string name="lobe_type" value="sinusoidal"/>
    <float name="multiplier" value="10.0"/>
    <float name="coherence" value="600000.0"/>
  </bsdf>
  <emitter type="directional">
    <vector name="direction" value="{_v(d)}"/>
    {_rgb("irradiance", (4.0, 4.0, 4.0))}
  </emitter>
  <emitter type="constant">{_rgb("radiance", (0.01, 0.01, 0.01))}</emitter>
  <shape type="rectangle">
    {_transform((0, -0.501, 0), (X, -90.0), (4.0, 4.0, 1.0))}
    <ref id="floor"/>
  </shape>
  <shape type="rectangle">
    {_transform((0, -0.5, 0), (X, -90.0), None)}
    <ref id="grating"/>
  </shape>
</scene>
"""
