"""The port's seven sensors against the JAX package's: each sensor's
`sample_ray` on seeded film and aperture samples, the sensor bridged from
a JAX Sensor and built by the port's own constructor, and the JAX
package's radiancemeter and irradiancemeter furnace checks
(`tests/test_sensors.py`) on the port."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.core import transform as jtf
from mitsuba3_plt_tpu.librender.sensor import Sensor as JSensor
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.core import transform as tf
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.librender import sensor as sn
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from mitsuba3_plt_tpu_torch.scene.presets import furnace_scene
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from test_torch_scene import jax_scene_arrays

N = 4096
POSE = ([0.3, 0.5, 3.0], [0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
SUBS = [jtf.look_at([x, 0.2, 3.0], [x, 0.0, 0.0], [0, 1, 0])
        for x in (-0.5, 0.0, 0.7)]


def _sensors(W, H):
    """{name: (JAX Sensor, the port's Sensor)}, built alike."""
    tw = jtf.look_at(*POSE)
    twt = tf.look_at(*POSE)
    kw = dict(device="cpu")
    return {
        "perspective": (JSensor.perspective(tw, 42.0, W, H, ppo=(0.01, -0.02)),
                        sn.Sensor.perspective(twt, 42.0, W, H,
                                              ppo=(0.01, -0.02), **kw)),
        "orthographic": (JSensor.orthographic(tw, W, H, 1.3),
                         sn.Sensor.orthographic(twt, W, H, 1.3, **kw)),
        "thinlens": (JSensor.thinlens(tw, 35.0, W, H, 0.08, 2.5),
                     sn.Sensor.thinlens(twt, 35.0, W, H, 0.08, 2.5, **kw)),
        "batch": (JSensor.batch_orthographic(np.stack(SUBS), W // 3, H, 0.6),
                  sn.Sensor.batch_orthographic(np.stack(SUBS), W // 3, H,
                                               0.6, **kw)),
        "radiancemeter": (JSensor.radiancemeter(tw),
                          sn.Sensor.radiancemeter(twt, **kw)),
        "irradiancemeter": (JSensor.irradiancemeter(tw, 0.4, 0.7),
                            sn.Sensor.irradiancemeter(twt, 0.4, 0.7, **kw)),
        "distant": (JSensor.distant([0.2, -1.0, 0.3], W, H,
                                    target=(0.1, 0.0, 0.0), radius=1.7),
                    sn.Sensor.distant([0.2, -1.0, 0.3], W, H,
                                      target=(0.1, 0.0, 0.0), radius=1.7,
                                      **kw)),
    }


@pytest.mark.parametrize("name", ["perspective", "orthographic", "thinlens",
                                  "batch", "radiancemeter",
                                  "irradiancemeter", "distant"])
def test_sample_ray_matches_jax(name):
    W, H = 24, 16
    jsens, tsens = _sensors(W, H)[name]
    jscene, _ = jpresets.cornell_box(8, 8)
    arrays, static = jax_scene_arrays(dataclasses.replace(jscene,
                                                          sensor=jsens))
    bridged = scene_from_arrays(arrays, static, device="cpu").sensor
    assert bridged.stype_static == tsens.stype_static == jsens.stype_static
    assert bridged.resolution == tsens.resolution == jsens.resolution
    for field in sn.FIELDS:
        np.testing.assert_array_equal(getattr(bridged, field).numpy(),
                                      getattr(tsens, field).numpy(),
                                      err_msg=field)
    rng = np.random.default_rng(len(name))
    uv = rng.random((N, 2), np.float32)
    ap = rng.random((N, 2), np.float32)
    uv[:4] = [[0, 0], [1, 1], [0.5, 0.5], [0.999999, 0]]
    ap[:4] = [[0.5, 0.5], [0, 0], [1, 1], [0.5, 0.0]]
    jo, jd = jsens.sample_ray(jnp.asarray(uv), jnp.asarray(ap))
    for sens in (bridged, tsens):
        to, td = sens.sample_ray(torch.as_tensor(uv), torch.as_tensor(ap))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-6)
    if name == "irradiancemeter":  # no aperture sample: the film's
        jo, jd = jsens.sample_ray(jnp.asarray(uv))
        to, td = tsens.sample_ray(torch.as_tensor(uv))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-6)
    assert tsens.reads_aperture == (name in ("thinlens", "irradiancemeter"))


def test_radiancemeter_reads_convex_furnace():
    scene = furnace_scene(8, 8, albedo=0.6, device="cpu")
    rm = sn.Sensor.radiancemeter(tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                                 device="cpu")
    scene = dataclasses.replace(scene, sensor=rm)
    img = render(scene, PathIntegrator(max_depth=5, rr_depth=9), seed=0,
                 spp=256)
    assert tuple(img.shape) == (1, 1, 3)
    assert abs(float(img.mean()) - 0.6) < 0.02


def test_irradiancemeter_unit_env():
    scene = furnace_scene(8, 8, albedo=0.6, device="cpu")
    im = sn.Sensor.irradiancemeter(
        tf.look_at([0, 3, 0], [0, 4, 0], [1, 0, 0]), device="cpu")
    scene = dataclasses.replace(scene, sensor=im)
    img = render(scene, PathIntegrator(max_depth=2, rr_depth=9), seed=0,
                 spp=256)
    # the cosine-weighted mean radiance of a unit environment is 1
    assert abs(float(img.mean()) - 1.0) < 0.02


def test_sensor_constructors_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sn.Sensor.perspective(np.eye(4), 40.0, 8, 8)
