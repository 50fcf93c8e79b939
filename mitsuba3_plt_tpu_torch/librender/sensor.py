"""Sensors: film-plane samples in [0,1]^2 (and aperture samples) ->
world-space rays, for the JAX package's seven sensor types
(`librender/sensor.py`): perspective, orthographic, thinlens, the batch of
orthographic sub-sensors, radiancemeter, irradiancemeter and distant. The
spectral response (`srf`) is not ported."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import frame as fr
from ..core import transform as tf
from ..core import warp
from ..core.device import resolve_device

SENSOR_PERSPECTIVE = 0
SENSOR_ORTHOGRAPHIC = 1
SENSOR_THINLENS = 2
SENSOR_BATCH = 3
SENSOR_RADIANCEMETER = 4
SENSOR_IRRADIANCEMETER = 5
SENSOR_DISTANT = 6
SENSOR_TYPES = tuple(range(7))

# the tensor fields of a Sensor, in the JAX package's order
FIELDS = ("stype", "to_world", "tan_half_x", "aspect", "near", "far",
          "aperture_radius", "focus_distance", "ortho_scale", "ppo")


@dataclasses.dataclass(frozen=True)
class Sensor:
    stype: torch.Tensor            # scalar int64
    to_world: torch.Tensor         # [4, 4] ([S, 4, 4] for the batch)
    tan_half_x: torch.Tensor       # scalar: tan(fov_x / 2)
    aspect: torch.Tensor           # scalar: width / height
    near: torch.Tensor
    far: torch.Tensor
    aperture_radius: torch.Tensor  # thinlens
    focus_distance: torch.Tensor   # thinlens: the focal plane's z
    ortho_scale: torch.Tensor      # [2] orthographic half-extents
    ppo: torch.Tensor              # [2] principal point offset
    resolution: tuple              # (width, height)
    stype_static: int = SENSOR_PERSPECTIVE

    # -- constructors: the JAX package's, on `device` -----------------------

    @staticmethod
    def _make(stype, to_world, width, height, device, tan_half_x=0.0,
              near=1e-2, far=1e4, aperture_radius=0.0, focus_distance=1.0,
              ortho_scale=(1.0, 1.0), ppo=(0.0, 0.0)):
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return Sensor(
            stype=torch.tensor(stype, dtype=torch.int64, device=dev),
            to_world=f32(to_world), tan_half_x=f32(tan_half_x),
            aspect=f32(width / height), near=f32(near), far=f32(far),
            aperture_radius=f32(aperture_radius),
            focus_distance=f32(focus_distance), ortho_scale=f32(ortho_scale),
            ppo=f32(ppo), resolution=(width, height), stype_static=stype)

    @staticmethod
    def perspective(to_world, fov_x_deg, width, height, near=1e-2, far=1e4,
                    ppo=(0.0, 0.0), *, device="cuda"):
        return Sensor._make(
            SENSOR_PERSPECTIVE, to_world, width, height, device,
            tan_half_x=np.tan(np.deg2rad(fov_x_deg) / 2), near=near, far=far,
            ppo=ppo)

    @staticmethod
    def orthographic(to_world, width, height, scale_x=1.0, scale_y=None,
                     near=1e-2, far=1e4, *, device="cuda", stype=None):
        if scale_y is None:
            scale_y = scale_x * height / width
        return Sensor._make(
            SENSOR_ORTHOGRAPHIC if stype is None else stype, to_world, width,
            height, device, near=near, far=far,
            ortho_scale=(scale_x, scale_y))

    @staticmethod
    def thinlens(to_world, fov_x_deg, width, height, aperture_radius,
                 focus_distance, near=1e-2, far=1e4, *, device="cuda"):
        return Sensor._make(
            SENSOR_THINLENS, to_world, width, height, device,
            tan_half_x=np.tan(np.deg2rad(fov_x_deg) / 2), near=near, far=far,
            aperture_radius=aperture_radius, focus_distance=focus_distance)

    @staticmethod
    def radiancemeter(to_world, *, device="cuda"):
        """A 1 x 1 film whose pixel is the radiance arriving at the origin
        along the sensor's +z axis."""
        return Sensor.orthographic(to_world, 1, 1, 0.0, 0.0, device=device,
                                   stype=SENSOR_RADIANCEMETER)

    @staticmethod
    def irradiancemeter(to_world, scale_x=1.0, scale_y=1.0, *,
                        device="cuda"):
        """Cosine-weighted hemispherical irradiance over a patch: rays start
        on the patch with cosine-distributed directions (the aperture
        sample), so the pixel's mean estimates E / pi times pi."""
        return Sensor.orthographic(to_world, 1, 1, scale_x, scale_y,
                                   device=device,
                                   stype=SENSOR_IRRADIANCEMETER)

    @staticmethod
    def distant(direction, width=1, height=1, target=(0.0, 0.0, 0.0),
                radius=1.0, *, device="cuda"):
        """Parallel rays arriving along `direction` over a disk of `radius`
        around `target`."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        tw = tf.look_at(np.asarray(target) - d * 1e4, target,
                        [0, 1, 0] if abs(d[1]) < 0.9 else [1, 0, 0])
        return Sensor.orthographic(tw, width, height, radius, radius,
                                   device=device, stype=SENSOR_DISTANT)

    @staticmethod
    def batch_orthographic(to_worlds, sub_width, height, scale_x=1.0,
                           scale_y=None, *, device="cuda"):
        """Orthographic sub-sensors side by side in one film of width
        S * sub_width; to_worlds [S, 4, 4]."""
        tws = np.asarray(to_worlds, np.float32)
        if scale_y is None:
            scale_y = scale_x * height / sub_width
        s = Sensor.orthographic(np.eye(4, dtype=np.float32),
                                tws.shape[0] * sub_width, height, scale_x,
                                scale_y, device=device, stype=SENSOR_BATCH)
        return dataclasses.replace(
            s, to_world=torch.as_tensor(tws, device=s.to_world.device))

    # -----------------------------------------------------------------------

    @property
    def reads_aperture(self) -> bool:
        """Whether sample_ray reads its aperture sample."""
        return self.stype_static in (SENSOR_THINLENS, SENSOR_IRRADIANCEMETER)

    def sample_ray(self, film_uv, aperture_uv=None):
        """film_uv [N, 2] -> (o [N, 3], d [N, 3]); u=0 is camera +x
        ('left'), v=0 is +y (top), the camera looks along +z. aperture_uv
        [N, 2] is the thinlens' lens sample and the irradiancemeter's
        direction sample (film_uv where None)."""
        u = film_uv[..., 0]
        v = film_uv[..., 1]
        st = self.stype_static

        if st == SENSOR_BATCH:
            S = self.to_world.shape[0]
            s_idx = torch.clamp((u * S).to(torch.int64), 0, S - 1)
            u_local = u * S - s_idx.to(torch.float32)
            Rb = self.to_world[s_idx, :3, :3]   # [N, 3, 3]
            tb = self.to_world[s_idx, :3, 3]
            x = (1.0 - 2.0 * u_local) * self.ortho_scale[0]
            y = (1.0 - 2.0 * v) * self.ortho_scale[1]
            o = Rb[..., 0] * x[..., None] + Rb[..., 1] * y[..., None] + tb
            return o, fr.normalize(Rb[..., :, 2])

        R = self.to_world[:3, :3]
        t = self.to_world[:3, 3]

        if st == SENSOR_RADIANCEMETER:
            shape = (*u.shape, 3)
            return (t.expand(shape).contiguous(),
                    fr.normalize(R[:, 2].expand(shape)))

        if st in (SENSOR_IRRADIANCEMETER, SENSOR_ORTHOGRAPHIC,
                  SENSOR_DISTANT):
            x = (1.0 - 2.0 * u) * self.ortho_scale[0]
            y = (1.0 - 2.0 * v) * self.ortho_scale[1]
            o_cam = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
            if st == SENSOR_IRRADIANCEMETER:
                if aperture_uv is None:
                    aperture_uv = torch.stack([u, v], -1)
                d_cam = warp.square_to_cosine_hemisphere(aperture_uv)
            else:
                d_cam = torch.tensor([0.0, 0.0, 1.0], device=u.device
                                     ).expand(o_cam.shape)
            return o_cam @ R.T + t, fr.normalize(d_cam @ R.T)

        tx = self.tan_half_x
        ty = self.tan_half_x / self.aspect
        x = (1.0 - 2.0 * (u + self.ppo[0])) * tx
        y = (1.0 - 2.0 * (v + self.ppo[1])) * ty
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)

        if st == SENSOR_THINLENS and aperture_uv is not None:
            p_lens = (warp.square_to_uniform_disk_concentric(aperture_uv)
                      * self.aperture_radius)
            p_focus = d_cam * (self.focus_distance / d_cam[..., 2:3])
            o_cam = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])],
                              dim=-1)
            return o_cam @ R.T + t, fr.normalize((p_focus - o_cam) @ R.T)

        o = t.expand(d_cam.shape).contiguous()
        return o, fr.normalize(d_cam @ R.T)
