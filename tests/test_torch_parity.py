"""The port's parity tools and the reference data they read.

- gpuraytracer_tpu_torch/utils/parity.py (compare, silhouette_mask,
  sensitivity_mask) gives tools/parity.py's numbers, key for key, on seeded
  images of several sizes; pack_mask / unpack_mask round-trip.
- The card-side tools (tools/torch_parity.py, torch_parity_floor.py,
  torch_parity_bisect.py) and utils/parity.py import with ``jax`` and the
  JAX package blocked.
- Each committed reference in tests/parity_refs/ (written by
  tools/torch_make_refs.py from the JAX package's XLA path on the CPU) has
  its scene's size, t, depth and name, is finite, and its chaos mask's mean
  is its sens_fraction.
- The port's plain distance functions on the CPU match the JAX package's
  values in tests/parity_refs/distance_seed7.npz within PLAIN_ULPS units of
  2^-23 * max(|d|, 1) (code 7, the Mandelbulb, differs by 9.1; the rest by
  2 or less).
- tools/torch_parity.py --device cpu on the 96x54 builtin golden (no mask)
  meets chip_smoke.py's image bar; the bisect rehearses on the CPU at 16x9.
- TORCH_PARITY.json and TORCH_PARITY_FLOOR.json, the card's artifacts, name
  the card and its power limit, cover builtin at 320x180 and meet the bars.

On a GPU (``cuda``) the distance entry of csrc/scene_kernel.cu is held to
its plain version. Outside Tier-1 (``slow``) tools/torch_make_refs.py
--goldens reproduces the committed mesh goldens bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpuraytracer_tpu_torch.models import meshes, scenes  # noqa: E402
from gpuraytracer_tpu_torch.utils import parity  # noqa: E402
from tools import parity as ref_parity  # noqa: E402
from tools import torch_make_refs, torch_parity  # noqa: E402
from tools import torch_parity_bisect, torch_parity_floor  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
PLAIN_ULPS = 16
CARD_ARTIFACTS = ("TORCH_PARITY.json", "TORCH_PARITY_FLOOR.json")


def seeded_pair(seed, h, w):
    """A reference, an image near it (some pixels far), and a chaos mask."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.0, 1.2, size=(h, w, 4)).astype(np.float32)
    ref[: h // 2, : w // 2] = 0.5  # a flat block, off the silhouette
    img = ref + rng.normal(0.0, 2e-4, size=ref.shape).astype(np.float32)
    far = rng.random((h, w)) < 0.05
    img[far] += rng.uniform(-0.2, 0.2, size=(int(far.sum()), 4)).astype(np.float32)
    moved = ref + np.where(rng.random((h, w, 1)) < 0.1, 0.01, 0.0).astype(np.float32)
    return img, ref, moved


@pytest.mark.parametrize("seed,h,w", [(0, 18, 32), (1, 54, 96), (2, 90, 160), (3, 12, 20)])
def test_compare_matches_the_reference_tool(seed, h, w):
    img, ref, moved = seeded_pair(seed, h, w)
    assert np.array_equal(parity.silhouette_mask(ref), ref_parity.silhouette_mask(ref))
    sens = parity.sensitivity_mask(ref, moved)
    assert np.array_equal(sens, ref_parity.sensitivity_mask(ref, moved))
    assert 0 < sens.sum() < sens.size
    assert parity.compare(img, ref) == ref_parity.compare(img, ref)
    assert parity.compare(img, ref, sens) == ref_parity.compare(img, ref, sens)
    assert np.array_equal(parity.unpack_mask(parity.pack_mask(sens), h, w), sens)


def test_card_side_tools_import_without_jax():
    src = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gpuraytracer_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from gpuraytracer_tpu_torch.utils import parity\n"
        "from tools import torch_parity, torch_parity_bisect, torch_parity_floor\n"
        "leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and\n"
        "                (m == 'jax' or m.startswith(('jax.', 'gpuraytracer_tpu.'))))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", src], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def scene_depth(name):
    if name == "builtin":
        return 3
    try:
        return scenes.get_config(name).max_depth
    except KeyError:
        return meshes.get_config(name).max_depth


@pytest.mark.parametrize("name", torch_make_refs.SCENES)
def test_reference_file(name):
    path = torch_make_refs.ref_path(name)
    ref = torch_parity.load_reference(path)
    z = np.load(path)
    w, h = torch_make_refs.size(name)
    assert ref["scene"] == name and (ref["width"], ref["height"]) == (w, h)
    assert (int(z["width"]), int(z["height"])) == (w, h)
    assert ref["image"].shape == (h, w, 4) and np.isfinite(ref["image"]).all()
    assert ref["t"] == pytest.approx(0.7) and ref["max_depth"] == scene_depth(name)
    assert str(z["source"]) == "gpuraytracer_tpu XLA, cpu"
    assert ref["sens"].shape == (h, w)
    assert float(ref["sens"].mean()) == pytest.approx(ref["sens_fraction"], abs=1e-12)
    assert 0.0 < ref["sens_fraction"] < 0.5


def test_references_stay_small():
    paths = [torch_make_refs.ref_path(n) for n in torch_make_refs.SCENES]
    paths.append(torch_parity_bisect.DISTANCE)
    assert sum(os.path.getsize(p) for p in paths) < 2.5e6


@pytest.mark.parametrize("code", torch_parity_bisect.CODES)
def test_plain_distance_matches_the_jax_values(code):
    from gpuraytracer_tpu_torch.geometry import sdf

    z = np.load(torch_parity_bisect.DISTANCE)
    assert z["points"].shape == (4096, 3)
    got = sdf.DISTANCE_FUNCTIONS[code](torch.from_numpy(z["points"])).numpy()
    assert float(torch_parity_bisect.ulps(got, z[f"d{code}"]).max()) <= PLAIN_ULPS


def test_parity_tool_on_the_cpu_meets_the_image_bar_on_the_golden(tmp_path):
    out = tmp_path / "parity.json"
    golden = os.path.join(HERE, "golden_builtin_96x54_t0p7.npz")
    assert torch_parity.main(["--device", "cpu", "--refs", golden, "--routes", "default",
                              "--out", str(out)]) == 0
    results = json.loads(out.read_text())
    assert results["device"] == "cpu" and len(results["entries"]) == 1
    entry = results["entries"][0]
    assert (entry["scene"], entry["width"], entry["height"]) == ("builtin", 96, 54)
    assert entry["image_bar"]["passes"], entry["image_bar"]
    assert "stable_pct_1e3" not in entry and entry["errors"] == []


def test_bisect_rehearses_on_the_cpu():
    out = torch_parity_bisect.run(log=lambda _: None, device="cpu", size=(16, 9))
    assert out["hit"]["rays"] == 144 and out["hit"]["gid_flips"] == 0
    assert out["dist"]["max_abs_vs_plain"] == 0.0 and out["shade"]["pct_gt_1e3"] == 0.0


def read_artifact(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CARD_ARTIFACTS)
def test_card_artifact_names_the_card(name):
    art = read_artifact(name)
    assert "H100" in art["device"], art["device"]
    assert art["power_limit"].endswith(" W"), art["power_limit"]


def test_card_parity_covers_every_scene_and_meets_its_bars():
    art = read_artifact("TORCH_PARITY.json")
    entries = {(e["scene"], e["route"]): e for e in art["entries"]}
    assert set(entries) == ({(s, "default") for s in torch_make_refs.SCENES}
                            | {("builtin", r) for r in torch_parity.ROUTES})
    builtin = entries[("builtin", "default")]
    assert builtin["width"] * builtin["height"] >= 320 * 180
    assert set(torch_parity.BARS) == set(entries)
    assert all(b >= t for b, t in zip(torch_parity.BARS[("builtin", "default")],
                                      torch_parity.TPU_BARS))
    for entry in entries.values():
        assert entry["errors"] == [] and torch_parity.misses(entry) == [], entry
        assert entry["launches"][entry["counter"]] > 0, entry


def test_card_floor_records_every_variant():
    art = read_artifact("TORCH_PARITY_FLOOR.json")
    assert art["width"] * art["height"] >= 320 * 180
    assert [v[0] for v in torch_parity_floor.VARIANTS] == list(art["variants"])
    assert isinstance(art["a_prime_bit_equal"], bool)
    assert list(art["vs_reference"]) == ["a", *art["variants"]]
    for v in art["variants"].values():
        assert 0.0 <= v["bit_equal_pct"] <= 100.0 and "stable_pct_1e3" in v


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the distance entry has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_distance_entry_matches_plain_on_cuda(cuda_device):
    from gpuraytracer_tpu_torch.geometry import sdf
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    pts = torch.from_numpy(np.load(torch_parity_bisect.DISTANCE)["points"]).to(cuda_device)
    for code in torch_parity_bisect.CODES:
        before = scene_kernel.PROBE_LAUNCHES
        got = scene_kernel.sdf_distance(code, pts).cpu().numpy()
        assert scene_kernel.PROBE_LAUNCHES == before + 1
        want = sdf.DISTANCE_FUNCTIONS[code](pts).cpu().numpy()
        assert np.isfinite(got).all()
        assert float(torch_parity_bisect.ulps(got, want).max()) <= torch_parity_bisect.DIST_ULPS


@pytest.mark.slow
def test_make_refs_goldens_reproduce_the_committed_mesh_goldens(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_make_refs.py"),
                           "--goldens", "--out", str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in torch_make_refs.MESH:
        fname = f"golden_torch_{name}_96x54_t0p7.npz"
        new, old = np.load(tmp_path / fname), np.load(os.path.join(HERE, fname))
        assert sorted(new.files) == sorted(old.files)
        for key in old.files:
            assert np.array_equal(new[key], old[key]) and new[key].dtype == old[key].dtype, key
