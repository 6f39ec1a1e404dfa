"""The plain reference: it imports nothing of JAX or the port, and it
renders what the port's plain CPU path renders, on every configuration
and on a described scene with a mesh (test data)."""

import ast
from pathlib import Path

import pytest
import torch

from rtbench import compare, core
from rtbench.reference import scene as ref_scene
from rtbench.reference import trace as ref_trace

REFERENCE = Path(core.ROOT) / "reference"
FORBIDDEN_HERE = ("jax", "jaxlib", "flax", "gpuraytracer_tpu", "gpuraytracer_tpu_torch")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_port(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN_HERE]
    assert not bad, f"{path.name} imports {bad}"


def _port_frame(cfg, t, size, monkeypatch):
    """The port's plain CPU frame of ``cfg`` at time t (route per_geometry:
    the per-geometry route's plain passes, as the card's route marches)."""
    from gpuraytracer_tpu_torch.accel import traverse
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.kernels import megakernel
    from gpuraytracer_tpu_torch.render import trace

    if cfg["route"] == "per_geometry":
        monkeypatch.setattr(traverse, "_procedural_pass",
                            lambda scene, plain, pack: megakernel.route_pass_plain)
    cfg = dict(cfg, width=size[0], height=size[1])
    scene, animate = core.load_module("scenes", cfg["port_scene"]).build(cfg, "cpu")
    arrays = animate(scene.arrays, torch.tensor(t, dtype=torch.float32))
    return trace.render_frame(Scene(scene.layout, arrays), size[0], size[1],
                              max_depth=int(cfg["max_depth"]))


SCENES = sorted((core.ROOT / "configs").glob("*.json")) + [
    Path(__file__).with_name("data") / "mesh_sdf_test.json"]


@pytest.mark.parametrize("t", [7.3, 41.9])
@pytest.mark.parametrize("path", SCENES, ids=lambda p: p.stem)
def test_reference_agrees_with_the_port_plain_path(path, t, monkeypatch):
    size = (40, 24)
    cfg = core.load_json(path)
    t = float(torch.tensor(t, dtype=torch.float32))
    port = _port_frame(cfg, t, size, monkeypatch)
    desc = ref_scene.SceneDescription(cfg["scene"])
    ref = ref_trace.render(desc.scene(size[0] / size[1], t, device="cpu"), cfg["route"], *size,
                           max_depth=int(cfg["max_depth"]))
    assert compare.f32_gap_pct(port, ref) == 0.0
    assert float((port - ref).abs().max()) < 1e-4


def test_reference_renders_rows_in_blocks_as_whole():
    cfg = core.load_json(core.ROOT / "configs" / "builtin_1080p.json")
    desc = ref_scene.SceneDescription(cfg["scene"])
    scene = desc.scene(2.0, 3.3, device="cpu")
    whole = ref_trace.render(scene, "frame", 20, 10, max_depth=3)
    blocks = ref_trace.render(scene, "frame", 20, 10, max_depth=3, rows=3)
    assert torch.equal(whole, blocks)
