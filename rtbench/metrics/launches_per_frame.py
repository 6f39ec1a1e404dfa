"""The port's kernel launches per frame in the window: the deltas of its
launch counters (render/program.counters(), which a replayed program adds
to as its eager frame would)."""


def read(run):
    r = run.generator.result
    return r.launches / r.frames if r.frames else None
