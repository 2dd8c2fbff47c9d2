"""Optimizer steps times the networks they train (an ensemble of S counts
S; a mesh counts its global steps once), over the whole timed window: from
the first timed chunk's launch to the host read after the last."""


def read(run):
    return run["net_steps"] / run["window_s"]
