"""The rounding spread of a float32 Gauss-Newton/LM "cg" run, beside the
same run on two ranks.

The dry run's Gauss-Newton leg (hpvpinns_tpu_torch/parallel/dryrun.py,
the twin of __graft_entry__.py's) takes the tiny Poisson-2D from the
seed-3 init through 2 accepted LM steps with the matrix-free CG solve and
holds the parameters to rtol 2e-3, atol 1e-5.  This script runs that leg
in float32 unsharded, unsharded with the elements in reversed order (the
same sums in another order, no sharding), and on two ranks (gloo), on each
device given, and prints each run's loss, CG iterations and distance from
the first run: how far float32 rounding alone moves the parameters.

    python tools/gn_f32_spread.py [DEVICE ...]     (default: cuda and cpu where there is a card, else cpu)
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.parallel.dryrun import _flat, _tiny_p2d  # noqa: E402

BOUND = dict(rtol=2e-3, atol=1e-5)


def gn(prob, mesh=None, data=None):
    """(params, loss, CG iterations of each accepted step, LM iterations)."""
    p = prob.init_params(torch.Generator().manual_seed(3))
    r = tv.gauss_newton(prob, p, data=data, iterations=2, solve="cg", mesh=mesh, verbose=False)
    return _flat(r.params), r.final_aux["loss"], r.history.get("cg_iters", np.array([])).tolist(), r.iterations_run


def reversed_data(prob):
    el = prob.data["elements"]
    return dict(prob.data, elements=type(el)(**{f.name: getattr(el, f.name).flip(0) for f in dataclasses.fields(el)}))


def child(argv):
    port, rank, n, out, device, backend = argv[:6]
    from hpvpinns_tpu_torch.parallel import distributed
    from hpvpinns_tpu_torch.parallel.sharding import element_mesh

    distributed.initialize(f"localhost:{port}", int(n), int(rank), backend=backend, device=device)
    mesh = element_mesh(device=device, backend=backend)
    p, loss, its, n_it = gn(tv.build(_tiny_p2d(), device=device), mesh)
    with open(out, "w") as f:
        json.dump({"p": p.tolist(), "loss": loss, "cg": its, "its": n_it}, f)
    distributed.shutdown()


def main(devices):
    from hpvpinns_tpu_torch.parallel.multihost_check import spawn

    runs = {}
    for dev in devices:
        prob = tv.build(_tiny_p2d(), device=dev)
        runs[dev] = gn(prob)
        runs[f"{dev}, elements reversed"] = gn(prob, data=reversed_data(prob))
        r = spawn([sys.executable, os.path.abspath(__file__), "--child"], 2, 300, dev, "gloo")[0]
        runs[f"{dev}, 2 ranks (gloo)"] = (np.asarray(r["p"]), r["loss"], r["cg"], r["its"])
    first = next(iter(runs))
    ref = runs[first][0]
    for label, (p, loss, its, n_it) in runs.items():
        d = np.abs(p - ref)
        beyond = int(np.sum(d > BOUND["atol"] + BOUND["rtol"] * np.abs(ref)))
        print(f"{label}: loss {loss!r}, CG iterations {its}, LM iterations {n_it}; against {first}: max abs "
              f"{d.max():.3e}, entries beyond rtol 2e-3 / atol 1e-5: {beyond}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2:])
    else:
        main(sys.argv[1:] or (["cuda", "cpu"] if torch.cuda.is_available() else ["cpu"]))
