"""The viewer loop's own host time per frame, in ms: the window's length
on the host clock less the seconds the loop spent blocked on frame fences
(FramePipeline.wait_seconds), over the frames."""


def read(run):
    r = run.generator.result
    if r.wait_s is None or not r.frames:
        return None
    return 1e3 * (r.seconds - r.wait_s) / r.frames
