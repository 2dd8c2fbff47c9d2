"""The JAX package's Gauss-Newton rows for AdvDiff's Tikhonov term on a
padded mesh: its loss masks padded elements and padded point columns, its
residual rows do not, so LM on a padded mesh lands elsewhere than LM
unsharded.  JAX on the CPU with 8 forced devices, float64.

The problem: AdvDiff identification with eps quadratic, epsilon_reg 0.1,
E 6 (3 x 2), 3 x 3 tests, (2, 6, 1), Q 5 (and Q 6, which no point axis of
2 pads); "qr", 2 accepted LM steps from `init_params(jax.random.key(0))`.
It prints each run's final loss and its relative gap to the unsharded run
of the same Q:

  Q 6 on element_point_mesh((2, 2))   (nothing padded)
  Q 5 on element_point_mesh((1, 2))   (Q padded 5 -> 6)
  Q 5 on element_mesh() of 8          (E padded 6 -> 8)

    python tools/jax_gn_tikhonov_padding.py

The port's rows zero both kinds of padding (hpvpinns_tpu_torch/problems/
advdiff.py::reg_resvec_fn); tests/test_torch_gauss_newton_point_mesh.py
holds it to JAX unsharded.
"""

import os
import sys

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import hpvpinns_tpu as jv  # noqa: E402
from hpvpinns_tpu.parallel.sharding import element_mesh, element_point_mesh  # noqa: E402


def final_loss(n_quad: int, mesh=None) -> float:
    cfg = jv.AdvDiffConfig(n_elements_x=3, n_elements_t=2, n_quad=n_quad, n_test_x=3, n_test_t=3, layers=(2, 6, 1),
                           epsilon_model="quadratic", epsilon_reg=0.1, dtype="float64")
    prob = jv.build(cfg)
    gn = jv.gauss_newton(prob, prob.init_params(jax.random.key(0)), iterations=2, solve="qr", mesh=mesh,
                         verbose=False)
    assert gn.accepted == 2, gn.accepted
    return float(gn.final_aux["loss"])


def main():
    ref = {q: final_loss(q) for q in (5, 6)}
    print(f"unsharded: Q 5 {ref[5]!r}, Q 6 {ref[6]!r}")
    for label, q, mesh in (("Q 6 on (2, 2), unpadded", 6, element_point_mesh((2, 2))),
                           ("Q 5 padded to 6 on (1, 2)", 5, element_point_mesh((1, 2))),
                           ("E 6 padded to 8 on element_mesh() of 8", 5, element_mesh())):
        loss = final_loss(q, mesh)
        print(f"{label}: {loss!r}, relative gap to unsharded Q {q} {abs(loss - ref[q]) / ref[q]:.3e}")


if __name__ == "__main__":
    main()
