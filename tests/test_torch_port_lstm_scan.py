"""The port's teacher-forced decoder recurrence and its reverse-time backward
(``ops/lstm_scan.py``) against ``imagecaptioner_tpu/ops/pallas_lstm.py``.

Float32 on the CPU, small shapes, operands from numpy seeds handed to both
sides.  The JAX kernels run in interpret mode, as the JAX package's own
tests run them here.  The JAX operands are (in, out) matrices and (1, 4H)
biases; the port's are their torch (out, in) transposes and (4H,) biases.

Tolerance 1e-5 absolute: both sides do the same float32 arithmetic and only
sum in different orders (values and gradients here are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import full_student_config
from imagecaptioner_tpu.models import lstm as JL
from imagecaptioner_tpu.ops import pallas_lstm as JP
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.models import lstm as PL
from imagecaptioner_tpu_torch.ops import lstm_scan as S
from imagecaptioner_tpu_torch.utils.convert import tree_to_state_dict

T, B, L, E, H, V = 5, 3, 7, 16, 24, 30
ATOL = 1e-5
FWD_NAMES = ("h_tops", "attn", "h0s", "c0s", "c1s")
# JAX names of the backward's outputs, in its order; all but the first three
# and the biases are (in, out), the transpose of the port's
JAX_GRADS = ("demb_w", "df_proj", "dfeats", "dw_h", "dw_c", "dw_ih0",
             "dw_hh0", "db0", "dw_ih1", "dw_hh1", "db1")
WEIGHTS = ("w_h", "w_c", "w_ih0", "w_hh0", "w_ih1", "w_hh1")


@pytest.fixture(scope="module")
def operands():
    """The twelve inputs in the JAX layout, as float32 numpy."""
    rng = np.random.default_rng(0)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    keep = rng.random((T, B, H)) < 0.7
    return dict(
        emb_w=r(T, B, E, sc=0.5), f_proj=r(B, L, E, sc=0.5), feats=r(B, L, E),
        mask=np.where(keep, 1.0 / 0.7, 0.0).astype(np.float32),
        w_h=r(H, E, sc=0.3), w_c=r(E, E, sc=0.3),
        w_ih0=r(E, 4 * H, sc=0.3), w_hh0=r(H, 4 * H, sc=0.3),
        b0=r(1, 4 * H, sc=0.1),
        w_ih1=r(H, 4 * H, sc=0.3), w_hh1=r(H, 4 * H, sc=0.3),
        b1=r(1, 4 * H, sc=0.1))


def _jax_ops(ops):
    return [jnp.asarray(ops[k]) for k in S.INPUTS]


def _port_ops(ops, dtype=torch.float32, mask=True):
    out = []
    for k in S.INPUTS:
        x = torch.from_numpy(ops[k])
        if k in WEIGHTS:
            x = x.t().contiguous()
        elif k in ("b0", "b1"):
            x = x[0]
        if k == "mask":
            out.append(x if mask else None)
        else:
            out.append(x.to(dtype) if k not in ("b0", "b1") or
                       dtype == torch.float64 else x)
    return out


def _to_port_layout(name, x):
    x = np.asarray(x)
    if name in ("dw_h", "dw_c", "dw_ih0", "dw_hh0", "dw_ih1", "dw_hh1"):
        return x.T
    return x[0] if name in ("db0", "db1") else x


@pytest.fixture(scope="module")
def forward(operands):
    ref = JP._fused_core_fwd_call(*_jax_ops(operands), interpret=True)
    with torch.no_grad():
        got = S.decoder_scan_plain(*_port_ops(operands), residuals=True)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("i", range(5), ids=FWD_NAMES)
def test_forward_with_mask_matches_the_jax_kernel(forward, i):
    ref, got = forward
    assert got[i].shape == ref[i].shape
    np.testing.assert_allclose(got[i], ref[i], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def cotangents():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((T, B, H)).astype(np.float32),
            rng.standard_normal((T, B, L)).astype(np.float32))


@pytest.fixture(scope="module")
def backward(operands, forward, cotangents):
    ref_fwd, _ = forward
    dh, da = cotangents
    res = _jax_ops(operands) + [jnp.asarray(x) for x in ref_fwd]
    kernel = JP._fused_core_bwd_pallas_call(*res, jnp.asarray(dh),
                                            jnp.asarray(da), interpret=True)
    twin = JP._fused_core_bwd(tuple(res), (jnp.asarray(dh), jnp.asarray(da)))
    twin = twin[:3] + twin[4:]          # drop the zero mask cotangent
    pres = _port_ops(operands) + [torch.from_numpy(x) for x in ref_fwd]
    got = S.decoder_scan_bwd_plain(pres, torch.from_numpy(dh),
                                   torch.from_numpy(da))
    return kernel, twin, [g.numpy() for g in got]


@pytest.mark.parametrize("i", range(11), ids=JAX_GRADS)
def test_backward_matches_the_jax_kernel_and_its_xla_twin(backward, i):
    """Non-zero dh_tops and dattns: the KD loss never feeds dattns, so only
    this test guards that route."""
    kernel, twin, got = backward
    name = JAX_GRADS[i]
    assert S.GRADS[i] == name
    assert np.abs(got[i]).max() > 1e-3          # a non-degenerate gradient
    for ref in (kernel[i], twin[i]):
        ref = _to_port_layout(name, ref)
        assert got[i].shape == ref.shape
        np.testing.assert_allclose(got[i], ref, atol=ATOL, rtol=0)


def test_backward_plain_agrees_with_autograd_in_float64(operands, cotangents):
    """The analytic backward against PyTorch autograd through the plain
    forward, both in float64: 1e-10 leaves only summation order."""
    ops = _port_ops(operands, torch.float64)
    ops = [o.double() if o is not None else o for o in ops]
    leaves = [o.clone().requires_grad_(k != "mask")
              for k, o in zip(S.INPUTS, ops)]
    out = S.decoder_scan_plain(*leaves, residuals=True)
    dh, da = (torch.from_numpy(c).double() for c in cotangents)
    ((out[0] * dh).sum() + (out[1] * da).sum()).backward()
    got = S.decoder_scan_bwd_plain(ops + [o.detach() for o in out], dh, da)
    assert all(g.dtype == torch.float64 for g in got)
    wanted = [leaf.grad for k, leaf in zip(S.INPUTS, leaves) if k != "mask"]
    for name, g, ref in zip(S.GRADS, got, wanted):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-10,
                                   rtol=0, err_msg=name)


def test_missing_cotangents_count_as_zero(operands, forward, cotangents):
    _, got_fwd = forward
    res = _port_ops(operands) + [torch.from_numpy(x) for x in got_fwd]
    dh = torch.from_numpy(cotangents[0])
    a = S.decoder_scan_bwd_plain(res, dh, None)
    b = S.decoder_scan_bwd_plain(res, dh, torch.zeros(T, B, L))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.fixture(scope="module")
def decoder():
    cfg = full_student_config(V, embed_size=E, hidden_size=H, dropout=0.3)
    p = jax.tree.map(np.asarray, JL.full_decoder_init(jax.random.PRNGKey(2),
                                                      cfg))
    pcfg = PC.full_student_config(V, embed_size=E, hidden_size=H, dropout=0.3)
    dec = PL.FullDecoder(pcfg)
    dec.load_state_dict(tree_to_state_dict(p), strict=True)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((B, L, E)).astype(np.float32)
    caps = rng.integers(0, V, (T, B)).astype(np.int32)
    return cfg, p, pcfg, dec, feats, caps


def test_eval_decoder_matches_the_flagless_jax_kernel(decoder):
    """``pallas_full_decoder_scan`` (no mask, no residuals) against the
    port's ``full_decoder_apply`` in eval mode, logits included."""
    cfg, p, pcfg, dec, feats, caps = decoder
    ref = JP.pallas_full_decoder_scan(p, jnp.asarray(feats),
                                      jnp.asarray(caps), cfg, interpret=True)
    with torch.no_grad():
        got = PL.full_decoder_apply(dec.eval(), torch.from_numpy(feats),
                                    torch.from_numpy(caps).long(), pcfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_train_decoder_with_jax_masks_matches_value_and_gradient(decoder):
    """Dropout on: the inter-layer and projection masks are derived exactly
    as ``pallas_full_decoder_scan_train`` derives them from its key and
    handed to the port, whose generator could never reproduce them.
    Compared: logits, and the gradient of a scalar loss with respect to
    every decoder parameter and the features (autograd through the plain
    forward here, the Pallas backward kernel in interpret mode there).
    Gradient tolerance 1e-4 absolute: the loss sums T*B*V logits."""
    cfg, p, pcfg, dec, feats, caps = decoder
    key = jax.random.PRNGKey(7)
    keep = 1.0 - cfg.dropout
    lstm_keep = np.stack([np.asarray(jax.random.bernoulli(
        jax.random.split(jax.random.fold_in(key, t), 2)[0], keep, (B, H)))
        for t in range(T)])
    proj_keep = np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, T), keep, (T, B, E)))
    w = np.random.default_rng(4).standard_normal((T, B, V)).astype(np.float32)

    def jax_loss(p_, f_):
        logits, _, _ = JP.pallas_full_decoder_scan_train(
            p_, f_, jnp.asarray(caps), cfg, train=True, rng=key,
            interpret=True)
        return jnp.sum(logits * w), logits

    (_, ref_logits), (gp, gf) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(feats))

    for q in dec.parameters():
        q.requires_grad_(True)
        q.grad = None
    f = torch.from_numpy(feats).requires_grad_(True)
    logits, _, _ = PL.full_decoder_apply(
        dec.train(), f, torch.from_numpy(caps).long(), pcfg, train=True,
        masks={"lstm": torch.from_numpy(lstm_keep),
               "proj": torch.from_numpy(proj_keep)})
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), atol=1e-4,
                               rtol=0)
    ref_grads = tree_to_state_dict(jax.tree.map(np.asarray, gp))
    for name, q in dec.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
        q.requires_grad_(False)
        q.grad = None


def test_cpu_tensors_take_the_plain_version_and_never_launch(operands):
    S.launches_eval = S.launches_train = S.launches_bwd = 0
    ops = _port_ops(operands)
    leaves = [o.clone().requires_grad_(k != "mask")
              for k, o in zip(S.INPUTS, ops)]
    h, a = S.decoder_scan(*leaves)
    ref = S.decoder_scan_plain(*ops)
    np.testing.assert_array_equal(h.detach().numpy(), ref[0].numpy())
    (h.sum() + a.sum()).backward()
    assert all(leaf.grad is not None for k, leaf in zip(S.INPUTS, leaves)
               if k != "mask")
    with pytest.raises(ValueError, match="CUDA"):
        S.decoder_scan_cuda(*ops)
    with pytest.raises(ValueError, match="CUDA"):
        S.decoder_scan_bwd_cuda(ops + list(ref) + [None] * 3, h.detach(), None)
    assert S.launches_eval == S.launches_train == S.launches_bwd == 0


def test_bf16_plain_forward_rounds_where_the_kernel_rounds(operands):
    """At bfloat16 the outputs keep the kernel's dtypes (h_tops and h0 in
    bf16; attn, c0, c1 float32) and stay near the float32 run: bf16 carries
    8 significant bits, and five steps do not amplify that past 0.1."""
    with torch.no_grad():
        out16 = S.decoder_scan_plain(*_port_ops(operands, torch.bfloat16),
                                     residuals=True)
        out32 = S.decoder_scan_plain(*_port_ops(operands), residuals=True)
    assert [o.dtype for o in out16] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.float32,
                                        torch.float32]
    for a, b in zip(out16, out32):
        assert float((a.float() - b).abs().max()) < 0.1
