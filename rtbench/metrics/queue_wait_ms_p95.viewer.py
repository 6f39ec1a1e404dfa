"""How long a frame waits on the card behind the frames ahead of it, in
ms: the 95th percentile (nearest rank) over the traced window's frames of
(device start - host enqueue), from the device marks that the port's
parallel/pipeline.FramePipeline records (utils/profile.py; the trace's
``marks``: (frame, enqueue_s, start_s, end_s) on the host clock). None
where the trace holds no marks (the CPU, a port without the recorder, or
a run that did not take the program's marks in)."""

from rtbench import stats


def read(run):
    marks = getattr(run.trace, "marks", None)
    if not marks:
        return None
    return 1e3 * stats.percentile([start - enqueue for _, enqueue, start, _ in marks], 0.95)
