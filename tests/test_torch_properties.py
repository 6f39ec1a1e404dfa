"""Property tests of the port's traversal (tests/test_properties.py's
invariants, on the same rays): accel/traverse.closest_hit and any_hit on
the CPU, the scene kernel's plain pass.

- hit t lies within [RAY_TMIN, RAY_TMAX], and a miss reports RAY_TMAX
- hit normals are unit length
- geometry ids index the geometry rows (plane included); a miss is -1
- a closest hit implies the occlusion query reports a hit for the same ray
- a ray from above the scene pointing up at the sky misses both queries

chip_smoke.py holds the CUDA scene kernel to the same invariants on the
same 2,048 rays.
"""

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core.types import RAY_TMAX, RAY_TMIN
from gpuraytracer_tpu_torch.models import builtin

N = 2048


@pytest.fixture(scope="module")
def random_query(rng):
    scene = builtin.build_scene(aspect=1.0, elapsed_time=1.3, device="cpu")
    # Rays from a shell around the scene pointed at random scene points.
    origins = rng.uniform(-14, 14, size=(N, 3))
    origins[:, 1] = rng.uniform(0.5, 12, size=N)
    targets = rng.uniform(-7, 7, size=(N, 3))
    targets[:, 1] = rng.uniform(0.0, 3.0, size=N)
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = torch.as_tensor(origins, dtype=torch.float32)
    d = torch.as_tensor(dirs, dtype=torch.float32)
    return scene, traverse.closest_hit(o, d, scene), traverse.any_hit(o, d, scene)


def test_hit_t_in_range(random_query):
    _, hit, _ = random_query
    t = hit.t.numpy()
    h = hit.hit.numpy()
    assert h.any(), "fuzz rays should hit something"
    assert (t[h] >= RAY_TMIN).all()
    assert (t[h] <= RAY_TMAX).all()
    np.testing.assert_array_equal(t[~h], RAY_TMAX)


def test_hit_normals_unit_and_facing(random_query):
    _, hit, _ = random_query
    h = hit.hit.numpy()
    lens = np.linalg.norm(hit.normal.numpy()[h], axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


def test_geometry_ids_valid(random_query):
    scene, hit, _ = random_query
    g = hit.geometry_id.numpy()
    h = hit.hit.numpy()
    assert ((g[h] >= 0) & (g[h] <= scene.layout.plane_geometry_id)).all()
    assert (g[~h] == -1).all()


def test_closest_implies_occluded(random_query):
    _, hit, occluded = random_query
    # Any ray with a valid closest hit must be reported occluded by the
    # any-hit query over the same extents.
    assert occluded.numpy()[hit.hit.numpy()].all()


def test_miss_rays_pointing_up_at_sky():
    scene = builtin.build_scene(aspect=1.0, elapsed_time=0.0, device="cpu")
    o = torch.tensor([[0.0, 30.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])
    assert not bool(traverse.closest_hit(o, d, scene).hit[0])
    assert not bool(traverse.any_hit(o, d, scene)[0])
