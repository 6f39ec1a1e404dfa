"""The host's scene build per frame inside the port, in ms: the port's
``models.scene`` spans (``AnimationState.scene``; utils/profile.py) in the
traced window, summed, over the frames; the inside twin of
scene_build_ms.viewer. None where the trace holds no such span (a port
without the recorder, or a run that did not take the program's spans in)."""

SPAN = "models.scene"


def read(run):
    frames = run.generator.result.frames
    if run.trace is None or not frames:
        return None
    seconds = [e - s for n, s, e in run.trace.spans if n == SPAN]
    return 1e3 * sum(seconds) / frames if seconds else None
