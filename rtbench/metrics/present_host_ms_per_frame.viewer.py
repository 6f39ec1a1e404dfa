"""The host's present per frame, in ms: the port's ``apps.present`` spans
(``render_cli.frame_to_host``'s RGBA8 conversion, its pinned host buffer
and the copy's enqueue; utils/profile.py) in the traced window, summed,
over the frames. None where the trace holds no such span (a port without
the recorder, or a run that did not take the program's spans in)."""

SPAN = "apps.present"


def read(run):
    frames = run.generator.result.frames
    if run.trace is None or not frames:
        return None
    seconds = [e - s for n, s, e in run.trace.spans if n == SPAN]
    return 1e3 * sum(seconds) / frames if seconds else None
