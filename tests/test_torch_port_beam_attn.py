"""The port's beam-step attention cores (``ops/beam_attn.py``) against the JAX
package's: the Pallas kernels in interpret mode and the XLA forms
(``_attend_anc``, grouped ``_attend_hm``), on one random cache, ancestry
table and memory from a numpy seed.  On the CPU the port's dispatchers take
their plain versions.

float32 atol 1e-5: the same float32 arithmetic summed in another order.
bfloat16 atol 2e-2: one rounding step of the weights and of the output on
values of order 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import beam_ancestry
from imagecaptioner_tpu.models import transformer as JTD
from imagecaptioner_tpu.ops import pallas_beam_attn as JBA
from imagecaptioner_tpu_torch.ops import beam_attn as BA

N, K, H, S, HD, L = 2, 3, 4, 9, 8, 7
E, R = H * HD, N * K
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _operands(k=K, seed=0):
    rng = np.random.default_rng(seed)
    r = N * k
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=f(r, 1, E), k=f(r, H, S, HD), v=f(r, H, S, HD),
                mk=f(N, H, L, HD), mv=f(N, H, L, HD),
                anc=rng.integers(0, k, (N, k, S)).astype(np.int32))


def _anc_at(anc, pos):
    """The caller's contract: identity at ``pos``."""
    anc = anc.copy()
    anc[:, :, pos] = np.arange(anc.shape[1], dtype=np.int32)[None]
    return anc


def _j(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


# (k, pos, dtype, ancestry table): random tables at every position, and
# tables built step by step as the beam search builds them ("lineage") or
# converged to one slot a position, as the card's checks use them
SELF_CASES = [(k, pos, dtype, "random") for k in (3, 5) for pos in (0, 5, S - 1)
              for dtype in ("float32", "bfloat16")]
SELF_CASES += [(k, S - 1, dtype, table) for table in ("lineage", "converged")
               for k in (3, 5) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize(
    "k,pos,dtype,table", SELF_CASES,
    ids=[f"{k}-{p}-{d}" + ("" if t == "random" else f"-{t}")
         for k, p, d, t in SELF_CASES])
def test_self_attention_plain_matches_pallas_and_xla(k, pos, dtype, table):
    o = _operands(k)
    anc = (_anc_at(o["anc"], pos) if table == "random" else beam_ancestry(
        np.random.default_rng(7), N, k, S, pos, table))
    jkv = {"k": _j(o["k"], dtype), "v": _j(o["v"], dtype)}
    ker = JBA.fused_beam_self_attention(
        _j(o["q"], dtype), jkv, jnp.asarray(anc), jnp.int32(pos), num_heads=H,
        interpret=True)
    causal = jnp.arange(S)[None, None, None, :] > pos
    xla = JTD._attend_anc(_j(o["q"], dtype), jkv["k"], jkv["v"],
                          jax.nn.one_hot(jnp.asarray(anc), k, dtype=dtype), H,
                          causal)
    got = BA.beam_self_attention(
        _t(o["q"], dtype), {"k": _t(o["k"], dtype), "v": _t(o["v"], dtype)},
        torch.from_numpy(anc), pos, num_heads=H)
    assert got.shape == (N * k, 1, E) and got.dtype == getattr(torch, dtype)
    for ref in (ker, xla):
        np.testing.assert_allclose(
            _np(got), np.asarray(ref.astype(jnp.float32)), atol=ATOL[dtype],
            rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 5])
def test_cross_attention_plain_matches_pallas_and_xla(k, dtype):
    o = _operands(k, seed=1)
    jmkv = {"k": _j(o["mk"], dtype), "v": _j(o["mv"], dtype)}
    ker = JBA.fused_beam_cross_attention(
        _j(o["q"], dtype), jmkv, mem_group=k, num_heads=H, interpret=True)
    xla = JTD._attend_hm(_j(o["q"], dtype).reshape(N, k, E), jmkv["k"],
                         jmkv["v"], H).reshape(N * k, 1, E)
    got = BA.beam_cross_attention(
        _t(o["q"], dtype), {"k": _t(o["mk"], dtype), "v": _t(o["mv"], dtype)},
        mem_group=k, num_heads=H)
    assert got.shape == (N * k, 1, E) and got.dtype == getattr(torch, dtype)
    for ref in (ker, xla):
        np.testing.assert_allclose(
            _np(got), np.asarray(ref.astype(jnp.float32)), atol=ATOL[dtype],
            rtol=0)


def test_q_may_be_a_column_block_of_a_packed_projection():
    """The dispatchers take q as ``dense(...).chunk(3)[0]`` hands it over."""
    o = _operands(seed=2)
    anc = _anc_at(o["anc"], 4)
    kv = {"k": _t(o["k"], "float32"), "v": _t(o["v"], "float32")}
    packed = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (R, 1, 3 * E)).astype(np.float32))
    q = packed.chunk(3, dim=-1)[0]
    assert not q.is_contiguous()
    a = BA.beam_self_attention(q, kv, torch.from_numpy(anc), 4, num_heads=H)
    b = BA.beam_self_attention(q.contiguous(), kv, torch.from_numpy(anc), 4,
                               num_heads=H)
    assert torch.equal(a, b)


def test_the_check_has_power_against_a_version_that_ignores_anc():
    """A self-attention that reads its own slot instead of ``anc[n, i, s]``
    is far outside the tolerance, as is one that reads past ``pos``."""
    o = _operands(seed=4)
    pos = 6
    anc = _anc_at(o["anc"], pos)
    kv = {"k": _t(o["k"], "float32"), "v": _t(o["v"], "float32")}
    q = _t(o["q"], "float32")
    good = BA.beam_self_attention_plain(q, kv, torch.from_numpy(anc), pos,
                                        num_heads=H)
    own_slot = np.broadcast_to(np.arange(K, dtype=np.int32)[None, :, None],
                               anc.shape).copy()
    assert (anc != own_slot).any()
    ignores = BA.beam_self_attention_plain(q, kv, torch.from_numpy(own_slot),
                                           pos, num_heads=H)
    late = BA.beam_self_attention_plain(q, kv, torch.from_numpy(anc), pos + 1,
                                        num_heads=H)
    assert (good - ignores).abs().max() > 100 * ATOL["float32"]
    assert (good - late).abs().max() > 100 * ATOL["float32"]


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """The CUDA wrappers check before they build or launch anything, and a
    tensor on another device than the CPU or a card is refused."""
    o = _operands(seed=5)
    q = _t(o["q"], "float32")
    kv = {"k": _t(o["k"], "float32"), "v": _t(o["v"], "float32")}
    anc = torch.from_numpy(o["anc"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        BA.beam_self_attention_cuda(q, kv, anc, 0, num_heads=H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        BA.beam_cross_attention_cuda(q, {"k": kv["k"][:N], "v": kv["v"][:N]},
                                     mem_group=K, num_heads=H)
    with pytest.raises(ValueError, match="unsupported device"):
        BA.beam_self_attention(q.to("meta"), kv, anc, 0, num_heads=H)
    with pytest.raises(ValueError, match="unsupported device"):
        BA.beam_cross_attention(q.to("meta"), kv, mem_group=K, num_heads=H)
    assert BA.launches_self == 0 and BA.launches_cross == 0


class StubEntry:
    """A C entry point in place of the built library's: records its calls
    and how often its ``argtypes`` are set, returns ``ret`` (0: success)."""

    def __init__(self, ret=0):
        self.calls, self.typed, self.ret, self.restype = [], 0, ret, None
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._argtypes = value
        self.typed += 1

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


def stub_launches(monkeypatch, module, cache, names, *, ret=0):
    """Route ``module``'s launches to stub entry points on the CPU: the
    library stub (no nvcc), launches without a device switch, the device
    check off; the module's entry-point cache and counters are restored
    afterwards.  Returns the stubs by name."""
    from imagecaptioner_tpu_torch.ops import _build
    stubs = {n: StubEntry(ret) for n in names}
    lib = type("StubLibrary", (), dict(stubs))()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "call_on", lambda dev, fn, *args: fn(*args, 0))
    monkeypatch.setattr(module, "_require_cuda", lambda t: None)
    monkeypatch.setattr(module, cache, None)
    for counter in [n for n in vars(module) if n.startswith("launches")]:
        monkeypatch.setattr(module, counter, getattr(module, counter))
    return stubs


def test_entry_points_are_typed_on_the_first_launch_only(monkeypatch):
    """Both wrappers take their entry points from one table made at the
    first launch: ``argtypes`` and ``restype`` are set once, not per call
    (the launches go to stubs, so no nvcc and no card are needed)."""
    stubs = stub_launches(monkeypatch, BA, "_KERNELS",
                          ("ic_beam_self_attention", "ic_beam_cross_attention"))
    anc = torch.from_numpy(_anc_at(_operands(seed=6)["anc"], 3))
    q = torch.zeros(R, 1, H * BA.HEAD_DIM)
    kv = {"k": torch.zeros(R, H, S, BA.HEAD_DIM),
          "v": torch.zeros(R, H, S, BA.HEAD_DIM)}
    mem = {"k": torch.zeros(N, H, L, BA.HEAD_DIM),
           "v": torch.zeros(N, H, L, BA.HEAD_DIM)}
    for _ in range(3):
        BA.beam_self_attention_cuda(q, kv, anc, 3, num_heads=H)
        BA.beam_cross_attention_cuda(q, mem, mem_group=K, num_heads=H)
    for stub in stubs.values():
        assert stub.typed == 1 and len(stub.calls) == 3
        assert stub.restype is not None
    assert BA.launches_self == 3 and BA.launches_cross == 3


def test_wrappers_name_the_limits_they_refuse(monkeypatch):
    """With the device check stubbed off, each refusal names its limit:
    hd = 64, L <= 256, 16-byte aligned memory and cache (bulk copies),
    S <= 64."""
    stub_launches(monkeypatch, BA, "_KERNELS",
                  ("ic_beam_self_attention", "ic_beam_cross_attention"))
    d = BA.HEAD_DIM
    q = torch.zeros(R, 1, H * d)
    mem = lambda Lm: {"k": torch.zeros(N, H, Lm, d),  # noqa: E731
                      "v": torch.zeros(N, H, Lm, d)}
    with pytest.raises(ValueError, match="hd=64"):
        BA.beam_cross_attention_cuda(torch.zeros(R, 1, H * 32), mem(L),
                                     mem_group=K, num_heads=H)
    with pytest.raises(ValueError, match="L <= 256"):
        BA.beam_cross_attention_cuda(q, mem(BA.MAX_L + 1), mem_group=K,
                                     num_heads=H)
    flat = torch.zeros(N * H * L * d + 1)
    shifted = {"k": flat[1:].view(N, H, L, d), "v": mem(L)["v"]}
    with pytest.raises(ValueError, match="16-byte aligned"):
        BA.beam_cross_attention_cuda(q, shifted, mem_group=K, num_heads=H)
    big = BA.MAX_S + 1
    kv = {"k": torch.zeros(R, H, big, d), "v": torch.zeros(R, H, big, d)}
    anc = torch.zeros(N, K, big, dtype=torch.int32)
    with pytest.raises(ValueError, match="S <= 64"):
        BA.beam_self_attention_cuda(q, kv, anc, 0, num_heads=H)
    flat = torch.zeros(R * H * S * d + 1)
    kv = {"k": flat[1:].view(R, H, S, d), "v": torch.zeros(R, H, S, d)}
    with pytest.raises(ValueError, match="kv must be 16-byte aligned"):
        BA.beam_self_attention_cuda(q, kv, torch.zeros(N, K, S, dtype=torch.int32),
                                    0, num_heads=H)
    assert BA.launches_self == 0 and BA.launches_cross == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_plan_fits_the_budget_and_chunks_only_what_does_not_fit(dtype):
    """The self kernel's plan (mirrored from ``csrc/beam_attention.cu``,
    which ``chip_smoke.py`` holds it against): every shape fits the shared
    memory budget; the serving shape (K=5, pos=19) and K=5 at the longest
    cache stage every row in one chunk; K=10 at pos=63 needs two chunks of
    positions at float32 and one at bf16; beams beyond 8 go to more blocks;
    a K whose slots do not fit one position still gets a plan."""
    item = torch.tensor([], dtype=dtype).element_size()
    for K in (1, 2, 5, 8, 9, 10, 64, 500, 1000):
        for pos in (0, 19, BA.MAX_S - 1):
            p = BA.self_plan(K, pos, dtype)
            assert p["smem"] <= BA.SELF_SMEM
            assert p["beams"] == min(K, BA.MAX_KG)
            assert p["groups"] * p["beams"] >= K > (p["groups"] - 1) * p["beams"]
            assert p["slots"] * p["positions"] * 2 * BA.HEAD_DIM * item \
                <= p["smem"]
            assert p["chunks"] == -(-K // p["slots"]) * -(-(pos + 1)
                                                         // p["positions"])
    main = BA.self_plan(5, 19, dtype)
    assert (main["beams"], main["groups"], main["slots"], main["positions"],
            main["chunks"]) == (5, 1, 5, 20, 1)
    assert BA.self_plan(5, BA.MAX_S - 1, dtype)["chunks"] == 1
    long = BA.self_plan(10, BA.MAX_S - 1, dtype)
    assert long["groups"] == 2 and long["slots"] == 10
    assert long["chunks"] == (2 if dtype == torch.float32 else 1)
    huge = BA.self_plan(1000, 5, dtype)
    assert huge["slots"] < 1000 and huge["positions"] == 1
