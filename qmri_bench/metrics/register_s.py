"""register_s: the whole window (until the registration running at the close
completed) over the registrations completed in it."""


def read(ctx):
    if ctx["workload"].iterations is None or not ctx["completed"]:
        return None
    return ctx["window_s"] / ctx["completed"]
