"""Real multi-process execution check.

Counterpart of hpvpinns_tpu/parallel/multihost_check.py.  Two local
processes form a torch.distributed world over a localhost TCP store, and
the element mesh (parallel/sharding.py) spans both, so the loss and
gradient all-reduce crosses the process boundary as it does between the
cards of a host or between hosts.

`run_multiprocess_check()` (the parent) spawns the children
`python -m hpvpinns_tpu_torch.parallel.multihost_check --child PORT ID N
OUT [DEVICE [BACKEND [SPEC]]]`; every child

  1. brings the world up through parallel.distributed.initialize(),
  2. builds the same problem (default the tiny Poisson-2D, `_tiny_config`),
  3. takes its shard of the elements on the element mesh,
  4. evaluates the loss and the gradients (one all-reduce of the shares),
     then optionally runs Gauss-Newton "cg" to 2 accepted steps and a
     number of eager Adam steps through `train` on the same mesh,

and writes its numbers as JSON, with its kernels' launch counts: over the
whole child (`launches`) or, with Adam steps, before their `train`
(`check_launches`) and in it alone (`adam_launches`).  The
parent computes the same problem UNSHARDED in its own process, on the same
device, and `assert_multiprocess_matches` holds every child to it.  A
child that does not finish within the timeout fails the call, and every
child is killed then.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

_N_PROC = 2
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# What the children and the reference run: a config (a preset of
# hpvpinns_tpu_torch.config by name, or None for `_tiny_config`) with
# dataclass overrides, whether to run the Gauss-Newton leg, and how many
# eager Adam steps to record.
DEFAULT_SPEC = {"preset": None, "overrides": {}, "gn": True, "adam_steps": 0}


def _tiny_config():
    import hpvpinns_tpu_torch as tv

    # float32 everywhere, as the JAX package's check: E 8, (2, 8, 8, 1)
    return tv.Poisson2DConfig(
        n_elements_x=4, n_elements_y=2, n_quad=4, n_test_x=3, n_test_y=3,
        layers=(2, 8, 8, 1), dtype="float32",
        train=tv.TrainConfig(iterations=1),
    )


def _config(spec: dict):
    import dataclasses

    from hpvpinns_tpu_torch import config as cfgmod

    cfg = _tiny_config() if spec.get("preset") is None else getattr(cfgmod, spec["preset"])()
    return dataclasses.replace(cfg, **spec.get("overrides", {}))


def jax_modules() -> list:
    """The modules of JAX or of the JAX package this process has loaded
    (none, in a child of this package)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hpvpinns_tpu"))


def _kernels() -> dict:
    from hpvpinns_tpu_torch.ops import fused_fields as ff

    return {"fused_fields": ff.fused_fields_kernel, "fused_fields_bwd": ff.fused_fields_bwd_kernel,
            "fused_fields_bwd_layered": ff.fused_fields_bwd_layered_kernel, "block_sum": ff.block_sum_kernel}


def _launch_counts() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _zero_launch_counts() -> None:
    for k in _kernels().values():
        k.launches = 0


def _loss_and_gradnorm_on_mesh(spec: dict, device: str, mesh=None) -> dict:
    """The shared child/parent computation: the loss, its gradient and the
    gradient's 2-norm at the seed-0 init, on `mesh` (None: unsharded), then
    Gauss-Newton/LM "cg" to 2 accepted steps from the seed-3 init and the
    losses of `adam_steps` Adam steps through `train`, where the spec asks,
    with the kernels' launches before that `train` (`check_launches`) and
    in it alone (`adam_launches`)."""
    import numpy as np
    import torch

    import hpvpinns_tpu_torch as tv
    from hpvpinns_tpu_torch.parallel.sharding import AXIS, allreduce_grads, replicate, shard_problem
    from hpvpinns_tpu_torch.problems.base import parameters

    cfg = _config(spec)
    prob = tv.build(cfg, device=device)
    params = prob.init_params(torch.Generator().manual_seed(0))
    data = prob.data
    if mesh is not None:
        data = shard_problem(data, mesh)
        params = replicate(params, mesh)
    leaves = parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    if mesh is None:
        loss, _ = prob.loss_fn(params, data)
        loss.backward()
    else:
        loss, _ = prob.loss_fn(params, data, axis_name=mesh.axis(AXIS))
        loss.backward()
        allreduce_grads(leaves, mesh.axis(AXIS))
    grads = torch.cat([t.grad.reshape(-1) for t in leaves]).detach()
    out = {
        "loss": float(loss.detach()),
        "grad_norm": float(torch.linalg.norm(grads.double())),
        "grads": grads.double().cpu().tolist(),
        "n_global_devices": 1 if mesh is None else mesh.size,
    }
    if spec.get("gn"):
        gn = tv.gauss_newton(prob, prob.init_params(torch.Generator().manual_seed(3)), iterations=2, solve="cg",
                             mesh=mesh, verbose=False)
        out.update(gn_loss=float(gn.final_aux["loss"]), gn_accepted=int(gn.accepted))
    if spec.get("adam_steps"):
        tc = tv.TrainConfig(iterations=int(spec["adam_steps"]), check_every=1, threshold=None)
        out["check_launches"] = _launch_counts()
        _zero_launch_counts()
        t0 = time.perf_counter()
        res = tv.train(prob, tc, mesh=mesh, verbose=False)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out.update(adam_loss=np.asarray(res.history["loss"]).tolist(), chunk_mode=res.chunk_mode,
                   adam_wall_s=time.perf_counter() - t0, adam_steps_per_sec=res.steps_per_sec,
                   adam_launches=_launch_counts())
    return out


def _child_main(argv: Sequence[str]) -> None:
    port, process_id, num_processes, out_path = argv[:4]
    device = argv[4] if len(argv) > 4 else "cpu"
    backend = argv[5] if len(argv) > 5 and argv[5] != "-" else None
    spec = json.loads(argv[6]) if len(argv) > 6 else DEFAULT_SPEC

    import torch

    from hpvpinns_tpu_torch.parallel import distributed
    from hpvpinns_tpu_torch.parallel.sharding import element_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    topo = distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=int(num_processes),
        process_id=int(process_id), backend=backend, device=device,
    )
    mesh = element_mesh(device=device, backend=backend)
    result = {**_loss_and_gradnorm_on_mesh(spec, device, mesh), **topo, "backend": mesh.backend,
              "device": str(mesh.device), "jax_modules": jax_modules()}
    if "adam_launches" not in result:
        result["launches"] = _launch_counts()
    with open(out_path, "w") as f:
        json.dump(result, f)
    distributed.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(command: Sequence[str], n: int, timeout_s: float, device: str = "cpu", backend: Optional[str] = None,
          extra: Sequence[str] = ()) -> list:
    """Start `n` children `command + [PORT, ID, N, OUT, DEVICE, BACKEND,
    *extra]` on one free localhost port, wait for all of them, and return
    each one's JSON result in rank order.  A child that fails, or a wait
    past `timeout_s`, raises; every child still running is killed first.
    The children's results and logs live in a temporary directory, removed
    on return."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="hpvpinn_mh_") as tmp:
        procs, outs, logs = [], [], []
        try:
            for rank in range(n):
                out = os.path.join(tmp, f"proc{rank}.json")
                log = open(os.path.join(tmp, f"proc{rank}.log"), "w+")
                outs.append(out)
                logs.append(log)
                procs.append(subprocess.Popen(
                    [*command, str(port), str(rank), str(n), out, device, backend or "-", *extra],
                    env={**env, "LOCAL_RANK": str(rank)}, stdout=log, stderr=subprocess.STDOUT, cwd=_REPO,
                ))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        bad = [i for i, (p, out) in enumerate(zip(procs, outs)) if p.returncode != 0 or not os.path.exists(out)]
        if bad:  # the child that failed on its own first (the others were killed after it)
            rank = min(bad, key=lambda i: (procs[i].returncode < 0, i))
            raise RuntimeError(f"child {rank} of {n} ({' '.join(command)}) failed, or the children passed "
                               f"{timeout_s} s (exit {procs[rank].returncode}):\n{texts[rank][-3000:]}")
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
        return results


def run_multiprocess_check(timeout_s: float = 300.0, device: str = "cpu", backend: Optional[str] = None,
                           spec: Optional[dict] = None) -> dict:
    """Spawn the two-rank world on `device` (every child's; "cuda" puts
    rank r on card r modulo the cards, so two ranks share one card) with
    `backend` (default: parallel/distributed.py's), and return the
    children's results and the reference: the same problem unsharded, in
    this process, on `device`."""
    spec = {**DEFAULT_SPEC, **(spec or {})}
    children = spawn([sys.executable, "-m", "hpvpinns_tpu_torch.parallel.multihost_check", "--child"], _N_PROC,
                     timeout_s, device, backend, [json.dumps(spec)])
    ref = _loss_and_gradnorm_on_mesh(spec, device)
    return {"children": children, "reference": ref, "spec": spec}


def assert_multiprocess_matches(result: dict, rtol: float = 1e-6, gn_rtol: float = 1e-4,
                                adam_rtol: float = 1e-4, grad_rtol: Optional[float] = None):
    """The two-rank world must compute the single process's numbers: the
    loss and the gradient's norm to `rtol` (and every gradient entry to
    `grad_rtol` where given), Gauss-Newton's 2 accepted steps to `gn_rtol`
    (the CG matvecs sum over the ranks in another order), and the Adam
    losses to `adam_rtol`."""
    import numpy as np

    ref = result["reference"]
    for child in result["children"]:
        assert child["process_count"] == _N_PROC, child["process_count"]
        assert child["n_global_devices"] == _N_PROC, child["n_global_devices"]
        assert child["jax_modules"] == [], child["jax_modules"]
        np.testing.assert_allclose(child["loss"], ref["loss"], rtol=rtol)
        np.testing.assert_allclose(child["grad_norm"], ref["grad_norm"], rtol=rtol)
        if grad_rtol is not None:
            g, gr = np.asarray(child["grads"]), np.asarray(ref["grads"])
            np.testing.assert_allclose(g, gr, rtol=grad_rtol, atol=grad_rtol * np.abs(gr).max())
        if "gn_loss" in ref:
            assert child["gn_accepted"] == ref["gn_accepted"] == 2, (child["gn_accepted"], ref["gn_accepted"])
            np.testing.assert_allclose(child["gn_loss"], ref["gn_loss"], rtol=gn_rtol)
        if "adam_loss" in ref:
            np.testing.assert_allclose(child["adam_loss"], ref["adam_loss"], rtol=adam_rtol)
            assert child["chunk_mode"] == ("graph" if child["backend"] == "nccl" else "eager"), child["chunk_mode"]


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        _child_main(sys.argv[2:])
    else:
        res = run_multiprocess_check()
        assert_multiprocess_matches(res)
        print(json.dumps({"children": [{k: v for k, v in c.items() if k != "grads"} for c in res["children"]],
                          "reference": {k: v for k, v in res["reference"].items() if k != "grads"}}, indent=2))
