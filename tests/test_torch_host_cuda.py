"""The CLI's frame loop on the card: 8 builtin frames with 3 in flight
make no host sync after the first two (torch.cuda.set_sync_debug_mode
"error" raises on any), and each frame's bytes are those of a direct
render of the same animation state. Skips without a GPU; this file
imports nothing of JAX, so it runs on the GPU machine with --noconftest."""

import pytest
import torch

from gpuraytracer_tpu_torch.apps import render_cli
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.models.animate import AnimationState
from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
from gpuraytracer_tpu_torch.render import trace
from gpuraytracer_tpu_torch.utils import png


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cli_frame_loop_makes_no_host_sync_with_three_frames_in_flight_on_cuda(cuda_device):
    cfg = RenderConfig(width=320, height=180)
    dt = 1.0 / 60.0
    pipe = FramePipeline(render_cli.frame_to_host(cfg, cuda_device), 3, device=cuda_device)
    done = {}

    def keep(i, host):
        done[i] = host

    state = render_cli.frame_loop(pipe, AnimationState.initial(), cfg, range(2), dt=dt,
                                  on_frame=keep)
    torch.cuda.set_sync_debug_mode("error")
    try:
        render_cli.frame_loop(pipe, state, cfg, range(2, 8), dt=dt, on_frame=keep)
        rest = pipe.drain()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    done.update(zip(range(8 - len(rest), 8), rest))
    assert sorted(done) == list(range(8))
    state = AnimationState.initial()
    for i in range(8):
        state = state.tick(dt, cfg)
        img = trace.render_frame(state.scene(cfg.aspect_ratio, device=cuda_device), 320, 180)
        assert (done[i].numpy() == png.image_f32_to_rgba8(img.cpu().numpy())).all(), i
