"""The port's fused in-batch softmax CE (``predictionio_tpu_torch/ops/fused_ce.py``)
on the CPU, against the JAX package's ``ops/fused_ce.py``.

The same numpy towers go through both. The JAX side runs its Pallas
kernels in interpret mode, as its own CPU tests do; the port runs the
plain versions, which mirror the kernels' arithmetic (bf16 operands, f32
accumulation, logits and exp rounded to bf16, dL rounded to bf16).

One rounding differs. Under XLA:CPU, which runs the interpret mode, XLA's
default ``xla_allow_excess_precision`` drops the bf16 rounding of the
exponential's output: the JAX side sums ``exp`` in f32, where the TPU kernel
and the port round it to bf16 (at most 2^-9 relative per term).

Tolerances:
* row/column sums: rtol 5e-3 (found at most 2.0e-3: the bf16 rounding of
  the exponentials above).
* the two gradient passes before the correction: atol 5e-3·max|ref|
  (found at most 3.3e-3·max|ref|, the same cause through ``c/rs``).
* loss: 1e-5 relative, inside the 1e-4 bar (found at most 4e-6).
* gradients: rtol 2e-2, atol 2e-4, the JAX package's interpret-vs-XLA bar
  (tests/test_fused_ce.py), and atol 1e-4 alone (found at most 4.2e-5).
* upstream-gradient scaling: exact to 1e-5.
* the unfused ("off") path against the JAX XLA formula: loss 1e-6
  relative (found equal), gradients rtol 1e-2, atol 1e-5 (found at most
  1.5e-5 absolute: both round the gradient of each bf16 operand to bf16,
  so an f32 difference in the last bits can move an element by a bf16
  step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.ops import fused_ce as jax_fused_ce
from predictionio_tpu_torch.ops import fused_ce as torch_fused_ce
from predictionio_tpu_torch.ops.twotower import inbatch_loss

INV_TEMP = 10.0
SHAPES = [(256, 16), (384, 8), (512, 64)]


def _towers(b, d, seed=0):
    rng = np.random.default_rng(seed)
    ue = rng.normal(size=(b, d)).astype(np.float32)
    ie = rng.normal(size=(b, d)).astype(np.float32)
    ue /= np.linalg.norm(ue, axis=1, keepdims=True)
    ie /= np.linalg.norm(ie, axis=1, keepdims=True)
    return ue, ie


def _jax_xla_loss(ue, ie):
    """The JAX package's XLA formulation (tests/test_fused_ce.py::_reference)."""
    labels = jnp.arange(ue.shape[0])

    def logits(a, b):
        return (
            jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16).T, preferred_element_type=jnp.float32)
            * INV_TEMP
        )

    l1 = optax.softmax_cross_entropy_with_integer_labels(logits(ue, ie), labels)
    l2 = optax.softmax_cross_entropy_with_integer_labels(logits(ie, ue), labels)
    return 0.5 * (l1.mean() + l2.mean())


def _torch_loss_and_grads(ue, ie, loss_fn):
    u = torch.from_numpy(ue).requires_grad_(True)
    i = torch.from_numpy(ie).requires_grad_(True)
    loss = loss_fn(u, i)
    gu, gi = torch.autograd.grad(loss, (u, i))
    return float(loss.detach()), gu.numpy(), gi.numpy()


@pytest.mark.parametrize(
    "B,D,inv_temp",
    [(8192, 64, 1.0), (256, 16, 1.0), (100, 64, 1.0), (256, 13, 1.0), (64, 64, 1.0),
     (256, 16, 10.0), (256, 16, 100.0), (256, 16, 0.0), (128, 8, 60.0), (128, 8, 60.5)],
)
def test_supported_shapes_match_jax(B, D, inv_temp):
    assert torch_fused_ce.fused_ce_supported(B, D, inv_temp) == jax_fused_ce.fused_ce_supported(B, D, inv_temp)


@pytest.mark.parametrize("b,d", SHAPES)
def test_plain_row_and_column_sums_match_jax_kernel(b, d):
    ue, ie = _towers(b, d)
    rs_j, cs_j = jax_fused_ce._fwd_call(jnp.asarray(ue), jnp.asarray(ie), INV_TEMP, True)
    u, i = torch.from_numpy(ue), torch.from_numpy(ie)
    rs, cs = torch_fused_ce.fused_ce_fwd_reference(u, i, INV_TEMP)
    np.testing.assert_allclose(rs.numpy(), np.asarray(rs_j)[:, 0], rtol=5e-3)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j)[0], rtol=5e-3)


@pytest.mark.parametrize("b,d", SHAPES)
def test_plain_gradient_passes_match_jax_kernel(b, d):
    """``bwd(ue, ie, rs, cs)`` is the JAX kernel's ``(d_ue, d_ie)``, the
    second accumulated down the tile's columns, before the positive-pair
    correction."""
    ue, ie = _towers(b, d, seed=1)
    rs_j, cs_j = jax_fused_ce._fwd_call(jnp.asarray(ue), jnp.asarray(ie), INV_TEMP, True)
    due_j, die_j = jax_fused_ce._bwd_call(jnp.asarray(ue), jnp.asarray(ie), rs_j, cs_j, INV_TEMP, True)
    u, i = torch.from_numpy(ue), torch.from_numpy(ie)
    rs = torch.from_numpy(np.asarray(rs_j)[:, 0].copy())
    cs = torch.from_numpy(np.asarray(cs_j)[0].copy())
    due, die = torch_fused_ce.fused_ce_bwd_reference(u, i, rs, cs, INV_TEMP)
    for got, want in ((due, due_j), (die, die_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3 * np.abs(want).max())


@pytest.mark.parametrize("b,d", SHAPES)
def test_swapped_gradient_pass_is_the_column_pass(b, d):
    """What the CUDA backward's second launch rests on: ``d_ie`` is the row
    pass with the towers and sums swapped, ``bwd(ie, ue, cs, rs)[0]``, and
    that call's column pass is ``d_ue``."""
    ue, ie = _towers(b, d, seed=5)
    u, i = torch.from_numpy(ue), torch.from_numpy(ie)
    rs, cs = torch_fused_ce.fused_ce_fwd_reference(u, i, INV_TEMP)
    due, die = torch_fused_ce.fused_ce_bwd_reference(u, i, rs, cs, INV_TEMP)
    die_swapped, due_swapped = torch_fused_ce.fused_ce_bwd_reference(i, u, cs, rs, INV_TEMP)
    for got, want in ((die_swapped, die), (due_swapped, due)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-3 * float(want.abs().max()))


@pytest.mark.parametrize("b,d", SHAPES)
@pytest.mark.parametrize("mode", ["interpret", "auto"])
def test_fused_loss_and_grads_match_jax_interpret(b, d, mode):
    ue, ie = _towers(b, d)
    want = float(jax_fused_ce.fused_inbatch_ce(jnp.asarray(ue), jnp.asarray(ie), INV_TEMP, True))
    g_want = jax.grad(
        lambda u, i: jax_fused_ce.fused_inbatch_ce(u, i, INV_TEMP, True), argnums=(0, 1)
    )(jnp.asarray(ue), jnp.asarray(ie))
    before = (torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches)
    got, gu, gi = _torch_loss_and_grads(
        ue, ie, lambda u, i: torch_fused_ce.fused_inbatch_ce(u, i, INV_TEMP, mode)
    )
    # on the CPU "auto" takes the plain versions: no kernel launch is counted
    assert (torch_fused_ce.fused_ce_fwd_cuda.launches, torch_fused_ce.fused_ce_bwd_cuda.launches) == before
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for g, w in zip((gu, gi), g_want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-2, atol=2e-4)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


def test_upstream_gradient_scales():
    ue, ie = _towers(256, 16)
    u = torch.from_numpy(ue).requires_grad_(True)
    i = torch.from_numpy(ie)
    (g1,) = torch.autograd.grad(torch_fused_ce.fused_inbatch_ce(u, i, INV_TEMP), (u,))
    (g3,) = torch.autograd.grad(3.0 * torch_fused_ce.fused_inbatch_ce(u, i, INV_TEMP), (u,))
    np.testing.assert_allclose(g3.numpy(), 3.0 * g1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("b,d", SHAPES)
def test_off_path_matches_jax_xla_formula(b, d):
    ue, ie = _towers(b, d, seed=2)
    want = float(_jax_xla_loss(jnp.asarray(ue), jnp.asarray(ie)))
    g_want = jax.grad(_jax_xla_loss, argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    got, gu, gi = _torch_loss_and_grads(ue, ie, lambda u, i: inbatch_loss(u, i, INV_TEMP, "bfloat16", "off"))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    for g, w in zip((gu, gi), g_want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-2, atol=1e-5)


def test_fused_loss_agrees_with_the_off_path():
    """The JAX package's own bar between its kernel and its XLA path."""
    ue, ie = _towers(256, 16)
    fused = _torch_loss_and_grads(ue, ie, lambda u, i: torch_fused_ce.fused_inbatch_ce(u, i, INV_TEMP))
    off = _torch_loss_and_grads(ue, ie, lambda u, i: inbatch_loss(u, i, INV_TEMP, "bfloat16", "off"))
    assert abs(fused[0] - off[0]) < 5e-3 * max(1.0, abs(off[0]))
    for g, w in zip(fused[1:], off[1:]):
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-4)


def test_column_sums_are_the_swapped_row_sums():
    """The loss's symmetry, which the backward's swapped launch rests on:
    the column sums of ``fwd(ue, ie)`` are the row sums of ``fwd(ie, ue)``
    and the tile summed down its columns."""
    ue, ie = _towers(256, 32, seed=4)
    u, i = torch.from_numpy(ue), torch.from_numpy(ie)
    tile = torch_fused_ce._exp_tile(torch_fused_ce._bf16(u), torch_fused_ce._bf16(i), INV_TEMP)
    rs, cs = torch_fused_ce.fused_ce_fwd_reference(u, i, INV_TEMP)
    rs_swapped, cs_swapped = torch_fused_ce.fused_ce_fwd_reference(i, u, INV_TEMP)
    np.testing.assert_allclose(cs.numpy(), tile.sum(dim=0).numpy(), rtol=1e-4)
    np.testing.assert_allclose(cs.numpy(), rs_swapped.numpy(), rtol=1e-4)
    np.testing.assert_allclose(rs.numpy(), cs_swapped.numpy(), rtol=1e-4)


def test_unsupported_inputs_raise():
    u = torch.zeros(100, 16)
    with pytest.raises(ValueError, match="does not take"):
        torch_fused_ce.fused_inbatch_ce(u, u, INV_TEMP)
    u = torch.zeros(128, 16)
    with pytest.raises(ValueError, match="mode"):
        torch_fused_ce.fused_inbatch_ce(u, u, INV_TEMP, "fast")


@pytest.mark.parametrize(
    "row_blocks,tiles,capacity,want",
    [(128, 128, 396, 3), (128, 128, 528, 4), (256, 256, 396, 3), (16, 16, 396, 16),
     (4, 4, 396, 4), (2000, 2000, 396, 2), (128, 128, 128, 1)],
)
def test_choose_splits(row_blocks, tiles, capacity, want):
    assert torch_fused_ce.choose_splits(row_blocks, tiles, capacity) == want
