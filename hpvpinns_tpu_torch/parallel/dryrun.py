"""Entry points: one training step, and the multi-device dry run.

The torch twin of the JAX package's __graft_entry__.py.  `entry()` returns
one Adam step of the flagship model (Poisson-2D, the configuration of
record) and its arguments.  `dryrun_multichip(n)` runs a world of n ranks,
one process each, over a localhost TCP store, and in every rank the legs
of __graft_entry__.py:53-258:

  1. the element mesh: one sharded Adam step (the loss and gradients of the
     shards summed in one all-reduce), whose updated parameters must equal
     the unsharded step's;
  2. the element x point mesh (n/2, 2) where n >= 4 is even: the same step
     with the fast quadrature axis split too;
  3. `poisson2d_scaled` (64 elements, 16 x 16 points, (2, 20, 20, 20, 1))
     sharded: one step, its loss against the unsharded one;
  4. Taylor-Green (the 3-axis Navier-Stokes system) sharded against
     unsharded;
  5. Gauss-Newton/LM "cg" to 2 accepted steps on the mesh against the
     unsharded run, in float64 (JAX's leg is float32, the TPU's widest):
     in float32 the CG iterates carry the reduction order so far that
     reversing the elements' order alone, unsharded, moves a parameter
     beyond the leg's bound (tools/gn_f32_spread.py), so only float64
     tells a sharding fault from rounding at that bound.

JAX runs one process and proves the collectives twice, through an explicit
shard_map with psum and through GSPMD's inserted all-reduce, then again in
a real 2-process cluster.  Every torch leg is already a multi-process
world with each collective written out, so those three legs are one here.
Each rank computes its unsharded references itself.

    python -m hpvpinns_tpu_torch.parallel.dryrun [N [DEVICE [BACKEND]]]
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional, Sequence

STEP_TOL = dict(rtol=1e-5, atol=1e-7)  # one f32 step, as __graft_entry__.py's legs
GN_TOL = dict(rtol=2e-3, atol=1e-5)  # two CG/LM solves, __graft_entry__.py's bound


def entry(device=None):
    """(fn, example_args): one Adam step of the flagship model on `device`
    (default the card).  fn(params, opt, data) -> (params, opt, loss)."""
    import torch

    import hpvpinns_tpu_torch as tv
    from hpvpinns_tpu_torch.training.trainer import _copy_params, make_optimizer

    cfg = tv.Poisson2DConfig(train=tv.TrainConfig(iterations=1))
    prob = tv.build(cfg, device=device)
    params = _copy_params(prob.init_params(torch.Generator().manual_seed(0)), as_parameters=True)
    opt = make_optimizer(cfg.train, params)

    def train_step(params, opt, data):
        opt.zero_grad(set_to_none=True)
        loss, _ = prob.loss_fn(params, data)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return train_step, (params, opt, prob.data)


def _tiny_p2d():
    import hpvpinns_tpu_torch as tv

    # 4 x 4 elements (padded and sharded over the ranks), 4-point quadrature
    return tv.Poisson2DConfig(n_elements_x=4, n_elements_y=4, n_quad=4, n_test_x=3, n_test_y=3,
                              layers=(2, 8, 8, 1), train=tv.TrainConfig(iterations=1))


def _flat(params):
    import torch

    from hpvpinns_tpu_torch.problems.base import parameters

    return torch.cat([t.detach().reshape(-1) for t in parameters(params)]).double().cpu().numpy()


def _one_step(prob, mesh=None):
    """(updated params, the step's loss): one Adam step from the seed-0
    init through `train`."""
    import hpvpinns_tpu_torch as tv

    res = tv.train(prob, tv.TrainConfig(iterations=1, check_every=1, threshold=None), mesh=mesh, verbose=False)
    return _flat(res.params), float(res.final_aux["loss"])


def _legs(device: str, mesh, mesh2d) -> dict:
    """The dry run's legs in this rank; raises where a leg disagrees."""
    import numpy as np
    import torch

    import hpvpinns_tpu_torch as tv

    out = {"mesh": mesh.shape}
    prob = tv.build(_tiny_p2d(), device=device)
    p_ref, loss_ref = _one_step(prob)
    p1, loss1 = _one_step(prob, mesh)
    np.testing.assert_allclose(loss1, loss_ref, rtol=1e-5, err_msg="element mesh step loss vs unsharded")
    np.testing.assert_allclose(p1, p_ref, **STEP_TOL, err_msg="element mesh updated params vs unsharded")
    out["loss"] = loss1
    if mesh2d is not None:
        p2, loss2 = _one_step(prob, mesh2d)
        np.testing.assert_allclose(loss2, loss_ref, rtol=1e-5, err_msg="2-D mesh step loss vs unsharded")
        np.testing.assert_allclose(p2, p_ref, **STEP_TOL, err_msg="2-D mesh updated params vs unsharded")
        out.update(mesh2d=mesh2d.shape, loss2d=loss2)

    scaled = tv.build(tv.poisson2d_scaled(n_elem_axis=8, n_quad=16, n_test=10), device=device)
    _, loss_s_ref = _one_step(scaled)
    _, loss_s = _one_step(scaled, mesh)
    np.testing.assert_allclose(loss_s, loss_s_ref, rtol=1e-5, err_msg="poisson2d_scaled sharded vs unsharded")
    el = scaled.data["elements"]
    out.update(scaled_loss=loss_s, scaled_shape=[el.x.shape[0], el.x.shape[1], el.x.shape[2]])

    ns = tv.build(tv.TaylorGreenConfig(dtype="float32", layers=(3, 8, 3), n_quad=4, n_elements_x=2,
                                       n_elements_y=2, n_elements_t=2, n_test_x=3, n_test_y=3, n_test_t=3,
                                       train=tv.TrainConfig(iterations=1)), device=device)
    _, loss_ns_ref = _one_step(ns)
    _, loss_ns = _one_step(ns, mesh)
    np.testing.assert_allclose(loss_ns, loss_ns_ref, rtol=1e-5, err_msg="taylorgreen sharded vs unsharded")
    out.update(ns_loss=loss_ns, ns_loss_ref=loss_ns_ref)

    prob64 = tv.build(dataclasses.replace(_tiny_p2d(), dtype="float64"), device=device)
    p_gn = prob64.init_params(torch.Generator().manual_seed(3))
    gn_ref = tv.gauss_newton(prob64, p_gn, iterations=2, solve="cg", verbose=False)
    gn = tv.gauss_newton(prob64, p_gn, iterations=2, solve="cg", mesh=mesh, verbose=False)
    np.testing.assert_allclose(gn.final_aux["loss"], gn_ref.final_aux["loss"], rtol=1e-4,
                               err_msg="sharded GN/LM (cg) loss vs unsharded")
    np.testing.assert_allclose(_flat(gn.params), _flat(gn_ref.params), **GN_TOL,
                               err_msg="sharded vs unsharded GN/LM (cg) params")
    if gn.accepted != 2:
        raise AssertionError(f"sharded GN/LM accepted {gn.accepted} steps, not 2")
    out.update(gn_loss=gn.final_aux["loss"], gn_loss_ref=gn_ref.final_aux["loss"])
    return out


def _child_main(argv: Sequence[str]) -> None:
    port, rank, n, out_path = argv[:4]
    device = argv[4] if len(argv) > 4 else "cpu"
    backend = argv[5] if len(argv) > 5 and argv[5] != "-" else None

    import torch

    from hpvpinns_tpu_torch.parallel import distributed
    from hpvpinns_tpu_torch.parallel.multihost_check import jax_modules
    from hpvpinns_tpu_torch.parallel.sharding import element_mesh, element_point_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=int(n), process_id=int(rank),
                           backend=backend, device=device)
    n = int(n)
    mesh = element_mesh(device=device, backend=backend)
    mesh2d = element_point_mesh((n // 2, 2), device=device, backend=backend) if n % 2 == 0 and n >= 4 else None
    result = {**_legs(device, mesh, mesh2d), "rank": int(rank), "backend": mesh.backend, "jax_modules": jax_modules()}
    with open(out_path, "w") as f:
        json.dump(result, f)
    distributed.shutdown()


def dryrun_multichip(n_devices: int, device: str = "cpu", backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> dict:
    """Run the legs (module docstring) in a world of `n_devices` ranks on
    `device` ("cuda": rank r on card r modulo the cards) with `backend`
    (default: parallel/distributed.py's), print one line, and return rank
    0's numbers.  A leg that disagrees, or a rank that does not finish in
    `timeout_s`, raises."""
    from hpvpinns_tpu_torch.parallel.multihost_check import spawn

    results = spawn([sys.executable, "-m", "hpvpinns_tpu_torch.parallel.dryrun", "--child"], n_devices, timeout_s,
                    device, backend)
    r = results[0]
    if any(res["jax_modules"] for res in results):
        raise AssertionError(f"a rank imported JAX: {[res['jax_modules'] for res in results]}")
    print(
        f"dryrun_multichip OK: {n_devices}-rank mesh {r['mesh']} ({r['backend']}, {device}), element-mesh step "
        f"loss {r['loss']:.6e}, updated params equal to the unsharded step's"
        + (f"; 2d-mesh {r['mesh2d']} loss {r['loss2d']:.6e}" if "mesh2d" in r else "")
        + f"; bench-scale config ({r['scaled_shape'][0]} elem x {r['scaled_shape'][1]}x{r['scaled_shape'][2]} "
        f"pts, layers (2, 20, 20, 20, 1)) sharded step loss {r['scaled_loss']:.6e}"
        f"; NS-system (taylorgreen) sharded step loss {r['ns_loss']:.6e} == unsharded {r['ns_loss_ref']:.6e}"
        f"; sharded GN/LM (cg, 2 accepted steps) loss {r['gn_loss']:.6e} == unsharded {r['gn_loss_ref']:.6e}",
        flush=True,
    )
    return r


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        _child_main(sys.argv[2:])
    else:
        args = sys.argv[1:]
        dryrun_multichip(int(args[0]) if args else 2, args[1] if len(args) > 1 else "cpu",
                         args[2] if len(args) > 2 else None)
