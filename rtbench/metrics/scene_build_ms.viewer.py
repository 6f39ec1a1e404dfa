"""The host's scene build per frame, in ms: the harness's span around
AnimationState.scene, summed over the window, over the frames."""


def read(run):
    r = run.generator.result
    if r.scene_s is None or not r.frames:
        return None
    return 1e3 * sum(r.scene_s) / r.frames
