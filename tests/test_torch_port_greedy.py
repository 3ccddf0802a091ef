"""The port's plain greedy decode against the JAX fused greedy kernel
(interpret mode) and the JAX scan decode, token for token at float32."""

import jax
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import full_student_config
from imagecaptioner_tpu.models import lstm as JL
from imagecaptioner_tpu.ops import decode as JD
from imagecaptioner_tpu.ops.pallas_greedy import pallas_greedy_decode_student
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.data.vocabulary import END, PAD
from imagecaptioner_tpu_torch.models.lstm import FullDecoder
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.utils.convert import tree_to_state_dict


def _setup(V, E, H, B, L, seed=0, end_bias=0.0):
    cfg = full_student_config(V, embed_size=E, hidden_size=H, dropout=0.0)
    dec = jax.tree.map(np.asarray,
                       JL.full_decoder_init(jax.random.PRNGKey(seed), cfg))
    dec["output_projection"]["fc2"]["bias"] = \
        dec["output_projection"]["fc2"]["bias"].copy()
    dec["output_projection"]["fc2"]["bias"][END] += end_bias
    feats = (np.random.default_rng(seed + 1).standard_normal((B, L, E)) * 0.3
             ).astype(np.float32)
    port = FullDecoder(PC.full_student_config(V, embed_size=E, hidden_size=H))
    port.load_state_dict(tree_to_state_dict(dec), strict=True)
    return cfg, {"decoder": dec}, feats, port


def _port_tokens(port, feats, T, temperature=1.0):
    x = torch.from_numpy(feats)
    w = G.greedy_operands(port, x.dtype)
    f_proj = G.attention_feature_projection(w, x)
    return G.greedy_decode_plain(w, x, f_proj, max_length=T,
                                 temperature=temperature).numpy()


@pytest.mark.parametrize("V,E,H,B,L,T,temperature", [
    (50, 16, 24, 2, 9, 8, 1.0),
    (50, 16, 24, 3, 7, 6, 2.0),
    (300, 256, 512, 4, 49, 20, 1.0),   # production widths
])
def test_plain_greedy_matches_jax(V, E, H, B, L, T, temperature):
    cfg, params, feats, port = _setup(V, E, H, B, L)
    got = _port_tokens(port, feats, T, temperature)
    kern = np.asarray(pallas_greedy_decode_student(
        params, feats, cfg, max_length=T, temperature=temperature,
        interpret=True))
    scan = np.asarray(JD.greedy_decode_student(
        params, feats, cfg, max_length=T, temperature=temperature))
    assert got.dtype == np.int32 and got.shape == (B, T)
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, scan)


def test_end_becomes_pad_and_rows_freeze():
    """With this seed rows finish at steps 1, 2 and 4 and two never do: the
    END step and every later step emit PAD, in both implementations."""
    V, E, H, B, L, T = 50, 16, 24, 6, 9, 10
    cfg, params, feats, port = _setup(V, E, H, B, L, seed=4)
    got = _port_tokens(port, feats, T)
    ref = np.asarray(JD.greedy_decode_student(params, feats, cfg,
                                              max_length=T, early_exit=False))
    np.testing.assert_array_equal(got, ref)
    assert not (got == END).any()
    first_pad = [(row == PAD).argmax() if (row == PAD).any() else T
                 for row in got]
    for row, fp in zip(got, first_pad):
        assert (row[fp:] == PAD).all() and (row[:fp] != PAD).all()
    # the case is only meaningful if some rows end mid-way and some do not
    assert 0 < min(first_pad) and min(first_pad) < T
    assert len(set(first_pad)) > 1


def test_sampling_path_is_seeded_and_pads_after_end():
    V, E, H, B, L, T = 50, 16, 24, 4, 9, 12
    _, _, feats, port = _setup(V, E, H, B, L, seed=5, end_bias=1.0)
    x = torch.from_numpy(feats)
    w = G.greedy_operands(port, x.dtype)
    f_proj = G.attention_feature_projection(w, x)

    def sample(seed):
        return G.greedy_decode_plain(
            w, x, f_proj, max_length=T, temperature=1.5,
            generator=torch.Generator().manual_seed(seed)).numpy()

    a, b = sample(0), sample(0)
    np.testing.assert_array_equal(a, b)
    assert not (a == END).any() and ((a >= 0) & (a < V)).all()
    for row in a:
        if (row == PAD).any():
            assert (row[(row == PAD).argmax():] == PAD).all()
