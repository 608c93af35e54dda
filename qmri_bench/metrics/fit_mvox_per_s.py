"""fit_mvox_per_s: every voxel of every fit request completed in the window,
over the whole window (until the last request, which ran past the close,
completed), in millions a second."""


def read(ctx):
    voxels = ctx["workload"].voxels
    if not voxels or not ctx["completed"]:
        return None
    return voxels * ctx["completed"] / ctx["window_s"] / 1e6
