"""The JAX half of the draw parity: JAX on the CPU, never on the card.

For each seed of an accuracy gap (`tools/draw_gaps.py`), build the JAX
package's problem with the train seed set to it, save its initial draw
`prob.init_params(jax.random.key(seed))` to `tools/draws/<config>_s<seed>.npz`
(keys from `hpvpinns_tpu_torch.convert.flatten_tree`), train the JAX package
from that draw over the config's full schedule, and put the run's numbers
into `tools/draws/jax_cpu.json` (one entry a gap and seed, replaced when run
again): the final metrics, the history, the phases' counts, the wall
seconds, the jax version and the CPU.  float64 gaps run with x64 on, float32
gaps with it off, as the JAX package's rows were made.

    python tools/jax_draws.py --gap C7 [--seeds 1234 0 ...]
    python tools/jax_draws.py --gap C7 --seeds 1234 --perturb 1e-15
        (JAX from the draw perturbed by 1e-15 relative: JAX's own spread
        from rounding-size changes, recorded beside the draw's run)
    python tools/jax_draws.py --gap C7 --seeds 1234 --bisect 5000 [--dtype float64]
        (the first N Adam steps, a record every 10, of JAX from the draw,
        JAX from the draw perturbed by --perturb (default 1e-15 in float64,
        6e-8 in float32) and the port on the CPU from the draw: where each
        first parts from JAX's run)

Several processes may run at once: the results file is locked around each
update.
"""

import argparse
import fcntl
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tools.draw_gaps import GAPS, JAX_RESULTS, config, draw_path, dump_runs, history, metrics, phases  # noqa: E402


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def flat_draw(tree) -> dict:
    from hpvpinns_tpu_torch.convert import flatten_tree

    return flatten_tree(jax.tree.map(np.asarray, tree))


def key(r: dict):
    return r["gap"], r["seed"], r.get("perturbed", 0.0)


def record(entry: dict) -> None:
    """Put `entry` into the results file under its (gap, seed, perturbation), holding a
    lock on the file across the read and the write."""
    os.makedirs(os.path.dirname(JAX_RESULTS), exist_ok=True)
    with open(JAX_RESULTS, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        runs = [r for r in (json.loads(text) if text.strip() else [])
                if key(r) != key(entry)]
        order = list(GAPS)
        runs = sorted(runs + [entry], key=lambda r: (order.index(r["gap"]), r["seed"], r.get("perturbed", 0.0)))
        f.seek(0)
        f.truncate()
        dump_runs(f, runs)


def perturbed(p0, rel: float, seed: int):
    """p0 with every entry scaled by (1 + rel N(0, 1)), the normals drawn by
    numpy from `seed`."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jax.numpy.asarray(np.asarray(a) * (1 + rel * rng.standard_normal(np.shape(a))),
                                                    dtype=a.dtype), p0)


def bisect(gap: str, seed: int, n: int, rel: float, dtype: str) -> None:
    """The first n Adam steps (a record every 10) of JAX from the draw, JAX
    from the draw perturbed by `rel`, and the port on the CPU from the draw,
    all in `dtype` (the JAX draw in that dtype, handed to the port as is):
    the first record where each run parts from JAX's by more than 1e-12
    relative in the loss, and the gaps every 250 steps."""
    import dataclasses

    import torch

    import hpvpinns_tpu as jv
    import hpvpinns_tpu_torch as tv
    def cut(c):
        return dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=n, lbfgs_iterations=0,
                                                                gn_iterations=0, check_every=10))

    prob = jv.build(cut(config(gap, jv, seed, dtype=dtype)))
    p0 = prob.init_params(jax.random.key(seed))
    runs = {"JAX": jv.train(prob, params=p0, verbose=False).history,
            f"JAX from the draw perturbed by {rel:g}": jv.train(prob, params=perturbed(p0, rel, seed),
                                                               verbose=False).history}
    cfg = cut(config(gap, tv, seed, dtype=dtype))
    runs["the port (CPU)"] = tv.train(tv.build(cfg, device="cpu"), verbose=False, params=tv.params_from_jax(
        jax.tree.map(np.asarray, p0), device="cpu", dtype=getattr(torch, cfg.dtype))).history
    ref = runs["JAX"]
    coef = next((k for k in ("epsilon", "k_sq", "vx") if k in ref), None)
    for label, h in list(runs.items())[1:]:
        d = np.abs(h["loss"] - ref["loss"]) / np.abs(ref["loss"])
        parts = np.flatnonzero(d > 1e-12)
        line = (f"{gap} seed {seed} {cfg.dtype}, {label} against JAX: first parts at step "
                f"{int(ref['iteration'][parts[0]]) if parts.size else 'never'} of {n}; loss gap")
        for i in range(24, len(d), 25):
            line += f" {int(ref['iteration'][i])}: {d[i]:.2e}"
            if coef:
                line += f" ({coef} {abs(h[coef][i] - ref[coef][i]) / abs(ref[coef][i]):.2e})"
        print(line, flush=True)


def run(gap: str, seed: int, rel: float = 0.0) -> None:
    import hpvpinns_tpu as jv

    cfg = config(gap, jv, seed)
    prob = jv.build(cfg)
    p0 = prob.init_params(jax.random.key(seed))
    if rel:
        p0 = perturbed(p0, rel, seed)
    else:
        np.savez(draw_path(gap, seed), **flat_draw(p0))
        print(f"{gap} {GAPS[gap].name} seed {seed}: draw saved to {os.path.relpath(draw_path(gap, seed))}",
              flush=True)
    t0 = time.perf_counter()
    res = jv.train(prob, params=p0, verbose=False)
    wall = time.perf_counter() - t0
    m = metrics(gap, jv, prob, res)
    record({"gap": gap, "config": GAPS[gap].name, "seed": seed, "perturbed": rel, "dtype": cfg.dtype,
            "deriv_mode": cfg.deriv_mode,
            "metrics": m, "phases": phases(cfg, res), "wall_s": wall, "history": history(res),
            "jax_version": jax.__version__, "cpu": cpu_model(), "cpu_count": os.cpu_count()})
    print(f"{gap} {GAPS[gap].name} seed {seed}{f' perturbed by {rel:g}' if rel else ''}: JAX CPU {cfg.dtype} metric {m['metric']!r} "
          f"({GAPS[gap].metric}), rel_l2 {m['rel_l2']!r}, final loss {m['final_loss']!r}, wall {wall:.1f} s",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gap", required=True, choices=sorted(GAPS))
    ap.add_argument("--seeds", type=int, nargs="*", help="default: the gap's seeds")
    ap.add_argument("--perturb", type=float, default=0.0, metavar="REL",
                    help="train from the draw perturbed by REL relative (nothing saved)")
    ap.add_argument("--bisect", type=int, metavar="N", help="compare the first N Adam steps (see above)")
    ap.add_argument("--dtype", choices=["float32", "float64"], help="--bisect in this dtype (default: the gap's)")
    a = ap.parse_args(argv)
    dtype = a.dtype or GAPS[a.gap].dtype
    jax.config.update("jax_enable_x64", dtype == "float64")
    for seed in a.seeds or GAPS[a.gap].seeds:
        if a.bisect:
            bisect(a.gap, seed, a.bisect, a.perturb or (1e-15 if dtype == "float64" else 6e-8), dtype)
        else:
            run(a.gap, seed, a.perturb)


if __name__ == "__main__":
    main()
