"""The host's time per frame in the port's frame function, in ms: the
port's ``render.frame`` spans (``trace.make_renderer``'s
``render(arrays)``: the key, the copy into the static inputs, the replay
and the outputs' clone; utils/profile.py) in the traced window, summed,
over the frames. None where the trace holds no such span (a port without
the recorder, or a run that did not take the program's spans in)."""

SPAN = "render.frame"


def read(run):
    frames = run.generator.result.frames
    if run.trace is None or not frames:
        return None
    seconds = [e - s for n, s, e in run.trace.spans if n == SPAN]
    return 1e3 * sum(seconds) / frames if seconds else None
