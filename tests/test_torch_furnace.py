"""The white furnace through the port's path tracer against the JAX package
(CPU), per lane: a diffuse, a conductor and a rough-conductor icosphere
(1,280 faces, the brute route) under a constant environment, which the
escaped rays see with MIS against its NEE density. The analytic check
(the centre at the albedo, the corner at the radiance) runs at full size
on the card (chip_smoke.py, phase furnace)."""
import pytest

from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_cbox_specular import one_torch_thread, per_lane  # noqa: F401


@pytest.mark.parametrize("max_depth,rr_depth", [(4, 9), (5, 2)])
@pytest.mark.parametrize("material", ["diffuse", "conductor",
                                      "roughconductor"])
def test_furnace_path_radiance_per_lane_matches_jax(material, max_depth,
                                                    rr_depth, monkeypatch):
    W = H = 16
    jscene = jpresets.furnace_scene(W, H, albedo=0.6, material=material)[0]
    tscene = tpresets.furnace_scene(W, H, albedo=0.6, material=material,
                                    device="cpu")
    got, want = per_lane(jscene, tscene,
                         JPath(max_depth=max_depth, rr_depth=rr_depth),
                         PathIntegrator(max_depth=max_depth,
                                        rr_depth=rr_depth),
                         W, H, 4, monkeypatch)
    # camera rays that miss the sphere see the environment's 1.0
    assert (got == 1.0).all(-1).mean() > 0.2
    assert ((got > 0) & (got < 1)).all(-1).mean() > 0.2


def test_furnace_escaped_rays_see_the_environment():
    """Depth 1: a camera ray that misses the sphere adds the radiance as
    it is (no MIS after the camera), one that hits it nothing yet."""
    scene = tpresets.furnace_scene(8, 8, radiance=1.5, device="cpu")
    img = render(scene, PathIntegrator(max_depth=1), spp=2).numpy()
    assert (img[0, 0] == 1.5).all() and (img[4, 4] == 0).all()
