"""The port's KV-cached teacher decoding (``models/transformer.py``
incremental path, ``ops/decode.py`` greedy and beam searches) against the JAX
package from one converted parameter tree: E=32, 4 heads, 2 decoder layers,
V=40, 32x32 images, float32 on the CPU, where the port's attention cores are
their plain versions and the JAX searches run their default XLA ancestry
path.

A random teacher never emits END, and then finalize, beam shrink, ``n_live``
and early exit would go unexercised.  ``sharpen`` scales the cross-attention
so that the images matter and raises the END bias; ``test_the_searches_*``
asserts that hypotheses finish at several lengths, that some images run out
of live beams early and that some never finish, before any equality counts.

Tolerances: tokens and lengths identical; scores 1e-4 (float32 sums of
log-probabilities in another order); one decoder step 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import TeacherConfig as JTeacherConfig
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.models import transformer as JTD
from imagecaptioner_tpu.ops import decode as JD
from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.data.vocabulary import END, PAD, START, Vocabulary
from imagecaptioner_tpu_torch.models import transformer as TD
from imagecaptioner_tpu_torch.models.teacher import Teacher
from imagecaptioner_tpu_torch.ops import decode as D
from imagecaptioner_tpu_torch.utils.convert import jax_teacher_to_state_dict

KW = dict(vocab_size=40, embed_size=32, num_heads=4, num_decoder_layers=2,
          dropout=0.0, encoder_dim=24, encoder_depth=2, encoder_heads=3,
          image_size=32, patch_size=16)
B, T = 8, 8
S = T + 1


def sharpen(p, end_bias):
    """Make the images matter (cross-attention scaled up) and END likely."""
    p = jax.tree.map(lambda a: np.array(a, copy=True), p)
    for layer in p["decoder"]:
        layer["multihead_attn"]["out_proj"]["weight"] *= 16.0
        layer["multihead_attn"]["in_proj_weight"] *= 2.0
    p["fc_out"]["bias"][END] += end_bias
    return p


@pytest.fixture(scope="module", params=[2.0, 20.0], ids=["mixed", "all_end"])
def teachers(request):
    """``mixed``: some hypotheses finish, some images never do.  ``all_end``:
    every beam ends in the first steps, so the loops exit early."""
    jcfg = JTeacherConfig(**KW)
    p = sharpen(JTM.teacher_init(jax.random.PRNGKey(0), jcfg), request.param)
    model = Teacher(TeacherConfig(**KW))
    model.load_state_dict(jax_teacher_to_state_dict(p), strict=True)
    images = (np.random.default_rng(1).standard_normal((B, 3, 32, 32)) * 2
              ).astype(np.float32)
    jmem = JTM.encode_image(p, jnp.asarray(images), jcfg)
    with torch.no_grad():
        mem = model.eval().encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=2e-5)
    return request.param, jcfg, p, model, jmem, mem


def _same(got, ref):
    """Whole output arrays: tokens and lengths identical, scores 1e-4 with
    the -inf padding in the same places."""
    gs, gsc, gl = (np.asarray(x) for x in got)
    rs, rsc, rl = (np.asarray(x) for x in ref)
    assert gs.dtype == np.int32 and gl.dtype == np.int32
    assert gs.shape == rs.shape and gsc.shape == rsc.shape
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_equal(np.isfinite(gsc), np.isfinite(rsc))
    fin = np.isfinite(rsc)
    np.testing.assert_allclose(gsc[fin], rsc[fin], atol=1e-4, rtol=0)


def _outcomes(scores, lens):
    scores, lens = np.asarray(scores), np.asarray(lens)
    fin = np.isfinite(scores)
    return dict(
        never=int((lens == S).all(1).sum()),
        ran_out=int((fin.all(1) & (lens.max(1) < S)).sum()),
        finished_lens=sorted(set(lens[fin & (lens < S)].tolist())))


@pytest.fixture(scope="module")
def jax_packed(teachers):
    """One compiled JAX packed search per (parameter set, K)."""
    _, jcfg, p, _, jmem, _ = teachers
    return {k: JD.beam_search_teacher_packed(p, jmem, jcfg, max_length=T,
                                             beam_size=k) for k in (3, 5)}


def test_precompute_memory_kv_and_one_cached_step(teachers):
    """``precompute_memory_kv`` and ``decoder_step_cached`` with and without
    an ancestry table, on a random half-filled cache."""
    _, jcfg, p, model, jmem, mem = teachers
    H, E, K, pos = 4, 32, 2, 3
    jmkv = JTD.precompute_memory_kv(p["decoder"], jmem, num_heads=H)
    mkv = TD.precompute_memory_kv(model.decoder, mem, num_heads=H)
    for a, b in zip(mkv, jmkv):
        for key in ("k", "v"):
            assert a[key].shape == (B, H, 5, E // H) and a[key].is_contiguous()
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                       atol=1e-5, rtol=0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, E)).astype(np.float32)
    cache = [{k: rng.standard_normal((B, H, S, E // H)).astype(np.float32)
              for k in ("k", "v")} for _ in range(2)]
    anc = rng.integers(0, K, (B // K, K, S)).astype(np.int32)
    anc[:, :, pos] = np.arange(K)[None]
    half = [{k: v[:B // K] for k, v in kv.items()} for kv in mkv]
    jhalf = [{k: v[:B // K] for k, v in kv.items()} for kv in jmkv]
    for group, m, jm, a in ((1, mkv, jmkv, None), (K, half, jhalf, None),
                            (K, half, jhalf, anc)):
        jy, jkv = JTD.decoder_step_cached(
            p["decoder"], jnp.asarray(x), jnp.int32(pos),
            [{k: jnp.asarray(v) for k, v in kv.items()} for kv in cache], jm,
            num_heads=H, mem_group=group,
            anc=None if a is None else jnp.asarray(a))
        with torch.no_grad():
            y, kv = TD.decoder_step_cached(
                model.decoder, torch.from_numpy(x), pos,
                [{k: torch.from_numpy(v.copy()) for k, v in kv.items()}
                 for kv in cache], m, num_heads=H, mem_group=group,
                anc=None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
        for got, ref in zip(kv, jkv):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(ref[key]), atol=1e-5,
                                           rtol=0)


def test_cached_greedy_equals_the_full_forward_argmax(teachers):
    """The KV-cached loop against re-running ``Teacher.forward`` on the
    growing prefix and taking the last position's argmax."""
    _, _, _, model, _, mem = teachers
    toks = D.greedy_decode_teacher(model, mem, max_length=T, early_exit=False)
    prefix = torch.full((1, B), START, dtype=torch.long)
    done = torch.zeros(B, dtype=torch.bool)
    for t in range(T):
        with torch.no_grad():
            nxt = model(None, prefix, memory=mem)[-1].argmax(-1)
        done |= nxt == END
        expect = torch.where(done, PAD, nxt)
        assert torch.equal(toks[:, t].long(), expect), t
        # a finished row keeps feeding its last real token
        prefix = torch.cat([prefix, torch.where(done, prefix[-1], nxt)[None]])


def test_greedy_matches_jax_and_early_exit_changes_nothing(teachers):
    bias, jcfg, p, model, jmem, mem = teachers
    ref = np.asarray(JD.greedy_decode_teacher(p, jmem, jcfg, max_length=T))
    on = D.greedy_decode_teacher(model, mem, max_length=T, early_exit=True)
    off = D.greedy_decode_teacher(model, mem, max_length=T, early_exit=False)
    assert on.dtype == torch.int32 and on.shape == (B, T)
    np.testing.assert_array_equal(on.numpy(), ref)
    np.testing.assert_array_equal(off.numpy(), ref)
    ended = int((ref == PAD).any(1).sum())
    assert ended == B if bias == 20.0 else 0 < ended < B


def test_sampled_greedy_is_seeded(teachers):
    bias, _, _, model, _, mem = teachers
    draw = lambda seed: D.greedy_decode_teacher(  # noqa: E731
        model, mem, max_length=T, temperature=1.5, sample=True,
        rng=torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b)
    # with END certain every draw is END at once, and the rows are all PAD
    assert (a == PAD).all() if bias == 20.0 else not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 40 and not (a == END).any()


@pytest.mark.parametrize("k", [3, 5])
def test_the_searches_finalize_shrink_and_exit_early(teachers, jax_packed, k):
    """The power of every equality below: what the reference run does."""
    bias, *_ = teachers
    o = _outcomes(*jax_packed[k][1:])
    if bias == 20.0:       # every beam ends at once: the loops stop early
        assert o["ran_out"] == B and o["never"] == 0
    else:
        assert o["never"] >= 1 and o["ran_out"] >= 1, o
        assert len(o["finished_lens"]) >= 3, o


@pytest.mark.parametrize("k", [3, 5])
def test_packed_beam_matches_jax(teachers, jax_packed, k):
    *_, model, _, mem = teachers
    _same(D.beam_search_teacher_packed(model, mem, max_length=T, beam_size=k),
          jax_packed[k])


def test_single_image_beam_matches_jax(teachers, jax_packed):
    _, jcfg, p, model, jmem, mem = teachers
    for i in (0, B - 1):
        ref = JD.beam_search_teacher(p, jmem[i:i + 1], jcfg, max_length=T,
                                     beam_size=3)
        got = D.beam_search_teacher(model, mem[i:i + 1], max_length=T,
                                    beam_size=3)
        assert got[0].shape == (3, S)
        _same(got, ref)
        _same(got, [x[i] for x in jax_packed[3]])
    with pytest.raises(ValueError, match="one image"):
        D.beam_search_teacher(model, mem[:2], max_length=T, beam_size=3)


def test_pipelined_beam_matches_jax(teachers, jax_packed):
    _, jcfg, p, model, jmem, mem = teachers
    ref = JD.beam_search_teacher_pipelined(p, jmem[:4], jcfg, pack=2,
                                           max_length=T, beam_size=3)
    got = D.beam_search_teacher_pipelined(model, mem[:4], pack=2, max_length=T,
                                          beam_size=3)
    _same(got, ref)
    _same(got, [x[:4] for x in jax_packed[3]])
    whole = D.beam_search_teacher_pipelined(model, mem, pack=B, max_length=T,
                                            beam_size=3)
    _same(whole, jax_packed[3])
    with pytest.raises(ValueError, match="not divisible"):
        D.beam_search_teacher_pipelined(model, mem, pack=3, max_length=T)


def test_batched_beam_matches_jax(teachers, jax_packed):
    _, jcfg, p, model, jmem, mem = teachers
    ref = JD.beam_search_teacher_batched(p, jmem, jcfg, max_length=T,
                                         beam_size=3)
    _same(D.beam_search_teacher_batched(model, mem, max_length=T, beam_size=3),
          ref)


def test_beam_early_exit_on_and_off_are_identical(teachers, jax_packed):
    """Outputs do not depend on ``early_exit``; with every beam ended the
    early loop really stops (it runs fewer decoder steps)."""
    bias, *_, model, _, mem = teachers
    steps = []
    real = TD.decoder_step_cached

    def counting(*a, **kw):
        steps[-1] += 1
        return real(*a, **kw)

    outs = []
    for ee in (True, False):
        steps.append(0)
        TD.decoder_step_cached = counting
        try:
            outs.append(D.beam_search_teacher_packed(
                model, mem, max_length=T, beam_size=3, early_exit=ee))
        finally:
            TD.decoder_step_cached = real
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _same(outs[0], jax_packed[3])
    assert steps[1] == T
    assert steps[0] < T if bias == 20.0 else steps[0] == T


def test_length_penalty_zero_and_captions(teachers):
    _, jcfg, p, model, jmem, mem = teachers
    ref = JD.beam_search_teacher_packed(p, jmem[:2], jcfg, max_length=T,
                                        beam_size=3, length_penalty=0.0)
    got = D.beam_search_teacher_packed(model, mem[:2], max_length=T,
                                       beam_size=3, length_penalty=0.0)
    _same(got, ref)
    jv, v = JVocabulary(freq_threshold=1), Vocabulary(freq_threshold=1)
    for vocab in (jv, v):
        vocab.build_vocabulary([" ".join(f"w{i}" for i in range(36))])
    for i in range(2):
        a = D.beam_result_to_captions(got[0][i].numpy(), got[1][i].numpy(), v, 3)
        b = JD.beam_result_to_captions(np.asarray(ref[0][i]),
                                       np.asarray(ref[1][i]), jv, 3)
        assert a == b and len(a) == int(np.isfinite(np.asarray(ref[1][i])).sum())
        assert all("<" not in c for c in a)     # no START / END / PAD
