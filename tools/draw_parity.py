"""The port's half of the draw parity: the port on the card (or, when asked,
the CPU), never JAX.

For each seed of an accuracy gap (`tools/draw_gaps.py`), train the port from
the JAX package's initial draw (`tools/draws/<config>_s<seed>.npz`, loaded by
`hpvpinns_tpu_torch.convert.load_draw`) and from its own draw at the same seed
(`torch.Generator().manual_seed(seed)`), over the config's full schedule, at
each of the gap's derivative modes; print one line a run beside the JAX
package's CPU run from the same draw (`tools/draws/jax_cpu.json`, written by
`tools/jax_draws.py`) and write every run to `chiprun_out/draw_parity_<gaps>.json`.

    python tools/draw_parity.py --gap C7 [C14 ...] [--seeds ...] [--draws jax own] [--device cuda|cpu]
    python tools/draw_parity.py --gap C9 --first-record --device cpu --draws jax
        (Adam up to the JAX run's first history record only: the run's gap to it)
    python tools/draw_parity.py --merge chiprun_out/draw_parity_*.json
        (the card's runs into tools/draws/port_h100.json)
    python tools/draw_parity.py --verdict
        (the verdict rule of PERF.md section 6, the draw parity, over the two files)

The device defaults to the card; `--device cpu` is the only way to the CPU.
"""

import argparse
import dataclasses
import fcntl
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.convert import load_draw  # noqa: E402
from hpvpinns_tpu_torch.problems.base import resolve_device  # noqa: E402
from tools.draw_gaps import (  # noqa: E402
    GAPS,
    JAX_RESULTS,
    PORT_RESULTS,
    config,
    draw_path,
    dump_runs,
    history,
    metrics,
    phases,
)

# The verdict rule (PERF.md section 6, the draw parity).  (i) from each of JAX's draws
# the port lands near JAX's CPU run from that draw: float64 within F64_METRIC
# relative on the final metric and F64_ADAM relative on the Adam phase's
# history records (loss and the identified coefficients), float32 within a
# factor F32_FACTOR on the final metric; (ii) the median of the port's own
# draws within a factor OWN_FACTOR of the median of JAX's draws.
F64_METRIC, F64_ADAM, F32_FACTOR, OWN_FACTOR = 1e-3, 1e-6, 2.0, 2.0
COEFFICIENTS = ("epsilon", "vx", "vy", "k_sq")


def gpu_line() -> str:
    """nvidia-smi's name and power limit of the card, or "" without one."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return ""


def load_json(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        fcntl.flock(f, fcntl.LOCK_SH)  # tools/jax_draws.py writes under LOCK_EX
        return json.load(f)


def jax_run(runs, gap, seed):
    """JAX's run from the draw itself (not a perturbed one)."""
    return next((r for r in runs if r["gap"] == gap and r["seed"] == seed and not r.get("perturbed")), None)


def plain(x):
    """JSON-safe: numpy scalars and arrays as floats and lists."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (np.generic, np.ndarray)):
        return x.tolist()
    return x


def train_one(gap, seed, mode, draw, device, first_record=None):
    """One port run: the config at `seed` in `mode`, from the JAX draw
    ("jax") or the port's own ("own"); `first_record` cuts the schedule to
    that many Adam steps."""
    cfg = config(gap, tv, seed, deriv_mode=mode)
    if first_record is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, iterations=first_record, lbfgs_iterations=0, gn_iterations=0))
    dev = resolve_device(device)
    prob = tv.build(cfg, device=dev)
    params = (load_draw(draw_path(gap, seed), device=dev, dtype=getattr(torch, cfg.dtype))
              if draw == "jax" else None)
    t0 = time.perf_counter()
    res = tv.train(prob, params=params, verbose=False)
    wall = time.perf_counter() - t0
    return {"gap": gap, "config": GAPS[gap].name, "seed": seed, "deriv_mode": mode, "draw": draw,
            "dtype": cfg.dtype, "device": str(dev), "metrics": metrics(gap, tv, prob, res),
            "phases": phases(cfg, res), "port_phases": plain(res.phases), "wall_s": wall,
            "chunk_mode": res.chunk_mode, "history": history(res)}


def run(a):
    jruns = load_json(JAX_RESULTS)
    gpu = gpu_line() if a.device != "cpu" else ""
    if gpu:
        print(f"card: {gpu}", flush=True)
    out = []
    for gap in a.gap:
        for seed in a.seeds or GAPS[gap].seeds:
            j = jax_run(jruns, gap, seed)
            first = None
            if a.first_record:
                if j is None:
                    raise SystemExit(f"{gap} seed {seed}: no JAX run in {JAX_RESULTS}")
                first = int(j["history"]["iteration"][0])
            for mode in a.modes or GAPS[gap].port_modes:
                for draw in a.draws:
                    r = train_one(gap, seed, mode, draw, a.device, first)
                    r.update(gpu=gpu, torch_version=torch.__version__)
                    m = r["metrics"]
                    line = (f"{gap} {r['config']} seed {seed} {mode} from the {draw} draw on {r['device']}: "
                            f"{GAPS[gap].metric} {m['metric']!r}, rel_l2 {m['rel_l2']!r}, final loss "
                            f"{m['final_loss']!r}, wall {r['wall_s']:.1f} s")
                    if j is not None and first is None:
                        line += f"; JAX CPU from its draw {GAPS[gap].metric} {j['metrics']['metric']!r}"
                    if j is not None and first is not None:
                        jl, tl = j["history"]["loss"][0], r["history"]["loss"][-1]
                        r["first_record"] = {"iteration": first, "jax_loss": jl, "port_loss": tl,
                                             "rel_gap": abs(tl - jl) / abs(jl)}
                        line += (f"; at iteration {first} loss {tl!r} against JAX's {jl!r}: relative gap "
                                 f"{abs(tl - jl) / abs(jl):.3e}")
                    print(line, flush=True)
                    out.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = ("_".join(a.gap) + "".join(f"_s{s}" for s in a.seeds or ())
            + ("" if len(a.draws) == 2 else f"_{a.draws[0]}") + ("_first" if a.first_record else ""))
    path = os.path.join(ROOT, "chiprun_out", f"draw_parity_{name}.json")
    with open(path, "w") as f:
        json.dump(plain(out), f, indent=1)
    print(f"wrote {os.path.relpath(path, ROOT)}", flush=True)


def merge(paths):
    """The card's runs (device cuda) from `paths` into port_h100.json, one
    entry a (gap, seed, mode, draw), a later run replacing an earlier one."""
    key = lambda r: (r["gap"], r["seed"], r["deriv_mode"], r["draw"])  # noqa: E731
    runs = {key(r): r for r in load_json(PORT_RESULTS)}
    for p in paths:
        for r in load_json(p):
            if not r["device"].startswith("cuda") or "first_record" in r:
                continue
            lbfgs = r["port_phases"].get("lbfgs", {})
            if "unsafe_at" in lbfgs:  # the iterations themselves: their count is kept
                lbfgs["unsafe_steps"] = len(lbfgs.pop("unsafe_at"))
            runs[key(r)] = r
    order = list(GAPS)
    with open(PORT_RESULTS, "w") as f:
        dump_runs(f, sorted(runs.values(), key=lambda r: (order.index(r["gap"]), r["seed"], r["deriv_mode"], r["draw"])))
    print(f"{len(runs)} runs in {os.path.relpath(PORT_RESULTS, ROOT)}")


def adam_records_gap(port, jax, n_adam):
    """The largest relative difference over the Adam phase's history records
    (iterations up to n_adam) in the loss and the identified coefficients."""
    worst = 0.0
    pit, jit = port["history"]["iteration"], jax["history"]["iteration"]
    for k in ("loss",) + COEFFICIENTS:
        if k not in jax["history"] or k not in port["history"]:
            continue
        for i, it in enumerate(jit):
            if it > n_adam or it not in pit:
                continue
            a, b = port["history"][k][pit.index(it)], jax["history"][k][i]
            if a is not None and b is not None and b != 0:
                worst = max(worst, abs(a - b) / abs(b))
    return worst


def verdict():
    """The rule over jax_cpu.json and port_h100.json: per gap and mode,
    (i) each same-draw pair, (ii) the medians; prints one line a pair and a
    verdict line a gap and mode."""
    jruns, pruns = load_json(JAX_RESULTS), load_json(PORT_RESULTS)
    for gap, g in GAPS.items():
        for mode in g.port_modes:
            same, own_p, own_j, seeds_i = [], [], [], []
            for seed in g.seeds:
                j = jax_run(jruns, gap, seed)
                pj = next((r for r in pruns if (r["gap"], r["seed"], r["deriv_mode"], r["draw"]) ==
                           (gap, seed, mode, "jax")), None)
                po = next((r for r in pruns if (r["gap"], r["seed"], r["deriv_mode"], r["draw"]) ==
                           (gap, seed, mode, "own")), None)
                if j is None:
                    continue
                jm = j["metrics"]["metric"]
                line = f"{gap} {g.name} {mode} seed {seed}: JAX CPU {jm:.4e}"
                jp = [r for r in jruns if r["gap"] == gap and r["seed"] == seed and r.get("perturbed")]
                if jp:
                    line += f" (from its draw perturbed by {jp[0]['perturbed']:g}: {jp[0]['metrics']['metric']:.4e})"
                if pj is not None:
                    pm = pj["metrics"]["metric"]
                    if g.dtype == "float64":
                        rel = abs(pm - jm) / abs(jm)
                        adam = adam_records_gap(pj, j, j["phases"]["adam"])
                        ok = rel <= F64_METRIC and adam <= F64_ADAM
                        line += (f", port from JAX's draw {pm:.4e} (relative {rel:.2e}; Adam records "
                                 f"{adam:.2e})")
                    else:
                        ratio = max(pm / jm, jm / pm)
                        ok = ratio <= F32_FACTOR
                        line += f", port from JAX's draw {pm:.4e} (factor {ratio:.3f})"
                    same.append(ok)
                    seeds_i.append(seed)
                    line += " (i) " + ("holds" if ok else "FAILS")
                if po is not None:
                    own_p.append(po["metrics"]["metric"])
                    own_j.append(jm)
                    line += f"; port's own draw {po['metrics']['metric']:.4e}"
                gpu = (pj or po or {}).get("gpu", "")
                print(line + (f" [{gpu}]" if gpu else ""))
            if not same and not own_p:
                print(f"{gap} {g.name} {mode}: no card runs yet")
                continue
            mp = statistics.median(own_p) if own_p else float("nan")
            mj = statistics.median(own_j) if own_j else float("nan")
            f2 = max(mp / mj, mj / mp) if own_p else float("nan")
            ii = own_p and f2 <= OWN_FACTOR
            print(f"{gap} {g.name} {mode} VERDICT: (i) {sum(same)} of {len(same)} draws hold (seeds {seeds_i}); "
                  f"(ii) median own {mp:.4e} against JAX's {mj:.4e} over {len(own_p)} seeds, factor {f2:.3f}: "
                  f"{'holds' if ii else 'FAILS'}")
            more = sorted({r["seed"] for r in pruns if (r["gap"], r["deriv_mode"], r["draw"]) == (gap, mode, "own")}
                          & {r["seed"] for r in jruns if r["gap"] == gap and not r.get("perturbed")})
            if len(more) > len(own_p):  # seeds beyond the gap's own: the medians' sampling spread
                from scipy import stats

                po = [r["metrics"]["metric"] for r in pruns if r["seed"] in more and (
                    r["gap"], r["deriv_mode"], r["draw"]) == (gap, mode, "own")]
                pj = [jax_run(jruns, gap, s)["metrics"]["metric"] for s in more]
                mp, mj = statistics.median(po), statistics.median(pj)
                print(f"{gap} {g.name} {mode} over all {len(more)} seeds run in both (beyond the rule's): median own "
                      f"{mp:.4e} against JAX's {mj:.4e}, factor {max(mp / mj, mj / mp):.3f}; the two samples' "
                      f"Mann-Whitney p {stats.mannwhitneyu(po, pj).pvalue:.3f}, Kolmogorov-Smirnov p "
                      f"{stats.ks_2samp(po, pj).pvalue:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gap", nargs="+", choices=sorted(GAPS))
    ap.add_argument("--seeds", type=int, nargs="*", help="default: the gap's seeds")
    ap.add_argument("--modes", nargs="*", help="default: the gap's deriv modes")
    ap.add_argument("--draws", nargs="+", default=["jax", "own"], choices=["jax", "own"])
    ap.add_argument("--device", default="cuda", help="default: the card")
    ap.add_argument("--first-record", action="store_true")
    ap.add_argument("--merge", nargs="+", metavar="JSON")
    ap.add_argument("--verdict", action="store_true")
    a = ap.parse_args(argv)
    if a.merge:
        merge(a.merge)
    elif a.verdict:
        verdict()
    elif a.gap:
        run(a)
    else:
        ap.error("give --gap, --merge or --verdict")


if __name__ == "__main__":
    main()
