"""The benchmark's metric arithmetic and its module guard."""

import pytest

from rtbench import core, stats, tracing
from rtbench.generators import WindowResult


def test_mrays_takes_every_frame_over_the_whole_window():
    # 100 frames of 1920x1080 in 0.25 s: 829.44 Mrays/s, however they fell.
    assert stats.mrays_per_second(1920, 1080, 100, 0.25) == pytest.approx(829.44)


def test_p95_is_over_every_frame():
    values = [1.0] * 95 + [50.0] * 5
    assert stats.percentile(values, 0.95) == 1.0
    assert stats.percentile(values + [60.0], 0.95) == 50.0
    assert stats.percentile(list(range(1, 1001)), 0.95) == 950


def _run(trace, frames=4, seconds=1.0):
    class D:
        result = WindowResult(frames=frames, seconds=seconds, attempted=frames, launches=8)

    return core.Run(cell=None, seed=0, seconds=seconds, traced=True, device=None, width=2,
                    height=2, generator=D(), trace=trace, work={"bound_ms_per_frame": 0.5})


def test_idle_share_counts_the_window_before_the_first_op_and_after_the_last():
    # window 0..10 s; device busy 2-3 and 4-6 (overlapping copy 5-6): 3 s busy.
    t = tracing.Trace(device=[("kernel", "k", 2.0, 3.0), ("kernel", "k", 4.0, 6.0),
                              ("gpu_memcpy", "c", 5.0, 6.0), ("kernel", "late", 11.0, 12.0)],
                      spans=[("submit", 0.0, 4.5)], window=(0.0, 10.0))
    assert t.busy_s == pytest.approx(3.0)
    assert t.kernel_s == pytest.approx(3.0)
    run = _run(t)
    assert core.load_module("metrics", "device_idle_pct").read(run) == pytest.approx(70.0)
    assert core.load_module("metrics", "kernel_ms_per_frame").read(run) == pytest.approx(750.0)
    assert core.load_module("metrics", "kernel_roofline_pct").read(run) == pytest.approx(
        100 * 0.5 / 750.0)
    gaps = dict(t.idle_gaps())
    assert gaps["submit"] == pytest.approx(3.0)  # 0-2 and 3-4
    assert gaps["(no span)"] == pytest.approx(4.0)  # 6-10


def test_readers_with_nothing_to_read_give_nothing():
    run = _run(None)
    for name in ("device_idle_pct", "kernel_ms_per_frame", "kernel_roofline_pct",
                 "frame_latency_ms_p95", "host_ms_per_frame.viewer", "scene_build_ms.viewer"):
        assert core.load_module("metrics", name).read(run) is None


def test_launches_and_mrays_readers():
    run = _run(None, frames=4, seconds=1.0)
    assert core.load_module("metrics", "launches_per_frame").read(run) == 2.0
    assert core.load_module("metrics", "mrays_per_s").read(run) == pytest.approx(16e-6)


def test_guard_compares_whole_top_level_names():
    assert core.forbidden_modules(["gpuraytracer_tpu_torch", "gpuraytracer_tpu_torch.render",
                                   "numpy", "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["gpuraytracer_tpu.models.builtin", "numpy"]) == [
        "gpuraytracer_tpu"]
    assert core.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


class _Event:
    """A profiler event of a PyTorch whose events carry no activity type."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


@pytest.mark.parametrize("name,device,kind", [
    ("frame_kernel<false, true>", "DeviceType.CUDA", "kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "DeviceType.CUDA", "gpu_memcpy"),
    ("Memset (Device)", "DeviceType.CUDA", "gpu_memset"),
    ("aten::add", "DeviceType.CPU", "cpu"),
])
def test_event_kinds_without_an_activity_type(name, device, kind):
    assert tracing.activity(_Event(name, device)) == kind
