"""Set-up: from the process's start (on a mesh the launcher's) to the
first timed chunk: imports, the build of the kernels' libraries where the
checkout has none, the problem's build, the weights, the capture of the
step and the first three steps."""


def read(run):
    return run["setup_s"]
