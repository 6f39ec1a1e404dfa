"""The 95th percentile (nearest rank) of every frame's latency in the
window, in ms: from its tick to the loop's receipt of its presented bytes."""

from rtbench import stats


def read(run):
    lat = run.generator.result.latencies_s
    return 1e3 * stats.percentile(lat, 0.95) if lat else None
