"""Million primary rays a second: W H times the frames completed in the
measured window over its whole length (host clock), / 1e6."""

from rtbench import stats


def read(run):
    r = run.generator.result
    return stats.mrays_per_second(run.width, run.height, r.frames, r.seconds)
