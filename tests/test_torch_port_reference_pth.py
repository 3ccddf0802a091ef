"""The port's import of the reference pipeline's ``.pth`` checkpoints
(``utils/reference_pth.py``) against the JAX package's
``utils/torch_convert.py``.

For the teacher and each of the three students a state dict in the
reference's key naming is built by JAX's ``TC.*_to_torch`` from a numpy
parameter tree (the port's ``teacher_init`` / ``student_init``, whose layout
is the JAX one).  The port's ``*_from_reference`` must give JAX's
``TC.*_from_torch`` tree leaf for leaf, bit-exact; ``*_to_reference`` JAX's
``TC.*_to_torch`` dict; every reference key must be consumed; and the tree
must load into the port's model with ``strict=True``.  No tolerance: the
conversion moves arrays, it computes nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.models import student_enhanced as JSE
from imagecaptioner_tpu.utils import torch_convert as TC
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.models import student_enhanced as PSE
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils import reference_pth as RP
from test_reference_pth import RefTeacherDecoder, _timm_encoder_state_dict

TKW = dict(vocab_size=40, embed_size=32, num_heads=2, num_decoder_layers=2,
           encoder_dim=24, encoder_depth=2, encoder_heads=2, patch_size=16,
           image_size=32)
V, E, H = 40, 16, 24
J_STUDENT = {"full": JC.full_student_config,
             "compact": JC.compact_student_config,
             "enhanced": JC.enhanced_student_config}
PORT = {"full": (RP.full_student_from_reference, RP.full_student_to_reference),
        "compact": (RP.compact_student_from_reference,
                    RP.compact_student_to_reference),
        "enhanced": (RP.enhanced_student_from_reference,
                     RP.enhanced_student_to_reference)}
JAX = {"full": (TC.full_student_from_torch, TC.full_student_to_torch),
       "compact": (TC.compact_student_from_torch, TC.compact_student_to_torch),
       "enhanced": (TC.enhanced_student_from_torch,
                    TC.enhanced_student_to_torch)}
MODELS = ["teacher", "full", "compact", "enhanced"]


def assert_trees_identical(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def cases():
    """Per model: the configs, the numpy trees, the reference-named state
    dict JAX exports from them, and JAX's import of that dict (the enhanced
    student's two extra projections drawn by JAX from its key)."""
    out = {}
    jcfg, pcfg = JC.TeacherConfig(**TKW), PC.TeacherConfig(**TKW)
    p = teacher_init(0, pcfg)
    sd = TC.teacher_to_torch(p, jcfg)
    out["teacher"] = dict(jcfg=jcfg, pcfg=pcfg, trees=(p,), sd=sd,
                          jax_import=(TC.teacher_from_torch(sd, jcfg),))
    for variant in ("full", "compact", "enhanced"):
        kw = dict(embed_size=E, hidden_size=H)
        jcfg = J_STUDENT[variant](V, **kw)
        pcfg = PC.STUDENT_CONFIGS[variant](V, **kw)
        p, s = student_init(1, pcfg)
        sd = JAX[variant][1](p, s, jcfg)
        extra = {} if variant != "enhanced" else {"key": jax.random.PRNGKey(3)}
        out[variant] = dict(jcfg=jcfg, pcfg=pcfg, trees=(p, s), sd=sd,
                            jax_import=JAX[variant][0](sd, jcfg, **extra))
    return out


def port_import(case, variant):
    if variant == "teacher":
        return (RP.teacher_from_reference(case["sd"], case["pcfg"]),)
    kw = {}
    if variant == "enhanced":   # the two arrays JAX drew, handed to the port
        dec = case["jax_import"][0]["decoder"]
        kw["projections"] = {n: jax.tree.map(np.asarray, dec[n]) for n in
                             ("query_projection", "highway_context_projection")}
    return PORT[variant][0](case["sd"], case["pcfg"], **kw)


@pytest.mark.parametrize("variant", MODELS)
def test_import_equals_jax_leaf_for_leaf(cases, variant):
    case = cases[variant]
    got = port_import(case, variant)
    assert_trees_identical(got, case["jax_import"])
    if variant != "enhanced":      # and it is the tree that was exported
        assert_trees_identical(got, case["trees"])


@pytest.mark.parametrize("variant", MODELS)
def test_export_equals_jax(cases, variant):
    case = cases[variant]
    if variant == "teacher":
        got = RP.teacher_to_reference(case["trees"][0], case["pcfg"])
    else:
        got = PORT[variant][1](*case["trees"], case["pcfg"])
    ref = case["sd"]
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("variant", MODELS)
def test_every_key_is_consumed(cases, variant):
    """A key the keymap does not read is refused, not dropped; the round
    trip gives back exactly the keys it was given."""
    case = cases[variant]
    sd = dict(case["sd"], **{"decoder.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="decoder.extra.weight"):
        if variant == "teacher":
            RP.teacher_from_reference(sd, case["pcfg"])
        else:
            PORT[variant][0](sd, case["pcfg"])
    trees = port_import(case, variant)
    back = (RP.teacher_to_reference(trees[0], case["pcfg"])
            if variant == "teacher" else PORT[variant][1](*trees, case["pcfg"]))
    assert set(back) == set(case["sd"])


@pytest.mark.parametrize("variant", MODELS)
def test_import_loads_strict(cases, variant):
    case = cases[variant]
    trees = port_import(case, variant)
    if variant == "teacher":
        model = Teacher(case["pcfg"])
        model.load_state_dict(CV.jax_teacher_to_state_dict(trees[0]),
                              strict=True)
    else:
        model = Student(case["pcfg"])
        model.load_state_dict(CV.jax_student_to_state_dict(*trees,
                                                           case["pcfg"]),
                              strict=True)
    got = dict(model.state_dict())
    want = (CV.jax_teacher_to_state_dict(trees[0]) if variant == "teacher"
            else CV.jax_student_to_state_dict(*trees, case["pcfg"]))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


class NotATensor:
    pass


def test_load_reference_pth_refuses_pickled_objects(tmp_path):
    path = str(tmp_path / "ck.pth")
    torch.save({"epoch": 2, "vocab_size": 7,
                "model_state_dict": {"w": torch.arange(3.0)}}, path)
    ck = RP.load_reference_pth(path)
    assert ck["epoch"] == 2 and isinstance(ck["model_state_dict"]["w"],
                                           np.ndarray)
    np.testing.assert_array_equal(ck["model_state_dict"]["w"], [0, 1, 2])
    torch.save({"model_state_dict": {"w": torch.zeros(2)},
                "extra": NotATensor()}, path)
    with pytest.raises(Exception, match="(?i)weights_only|unpickl"):
        RP.load_reference_pth(path)
    assert isinstance(RP.load_reference_pth(path, allow_pickle=True)["extra"],
                      NotATensor)


def test_production_teacher_keys_are_covered(tmp_path):
    """A production-width reference checkpoint (timm ViT-S/16 names, a real
    ``nn.TransformerDecoder`` at 512/8/4, its ``pe`` buffer, V=997), saved
    with ``torch.save`` in the reference's wrapper dict, reads back through
    ``load_reference_pth`` -> ``teacher_from_reference`` with every key
    consumed and loads into the port's teacher with ``strict=True``."""
    torch.manual_seed(7)
    sd = dict(RefTeacherDecoder().state_dict())
    assert "pe" in sd
    sd.update(_timm_encoder_state_dict(np.random.default_rng(11)))
    path = str(tmp_path / "best_teacher_model.pth")
    torch.save({"epoch": 3, "model_state_dict": sd, "vocab_size": 997,
                "optimizer_state_dict": {}, "val_loss": 2.5}, path)
    ck = RP.load_reference_pth(path)
    cfg = PC.TeacherConfig(vocab_size=int(ck["vocab_size"]))
    keys = set(RP.teacher_to_reference(
        RP.teacher_from_reference(ck["model_state_dict"], cfg), cfg))
    assert keys == set(sd) - {"pe"}
    model = Teacher(cfg)
    model.load_state_dict(CV.jax_teacher_to_state_dict(
        RP.teacher_from_reference(ck["model_state_dict"], cfg)), strict=True)
    assert torch.equal(model.fc_out.weight, sd["fc_out.weight"])
    assert torch.equal(model.encoder.blocks[11].mlp.fc2.weight,
                       sd["encoder.blocks.11.mlp.fc2.weight"])


def test_enhanced_forward_with_the_same_projections_matches_jax(cases):
    """The two projections the reference lacks act in the enhanced decoder:
    with the arrays JAX drew handed to the port, the decoder of the imported
    student gives JAX's outputs on the same features and captions (float32,
    2e-5 absolute: the same arithmetic summed in another order).  Drawn from
    the port's own seed instead, they differ from JAX's."""
    case = cases["enhanced"]
    params, state = port_import(case, "enhanced")
    model = Student(case["pcfg"])
    model.load_state_dict(CV.jax_student_to_state_dict(params, state,
                                                       case["pcfg"]),
                          strict=True)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 9, E)).astype(np.float32)
    caps = rng.integers(0, V, (5, 2)).astype(np.int32)
    ref = JSE.enhanced_decoder_apply(
        jax.tree.map(jnp.asarray, case["jax_import"][0]["decoder"]),
        jnp.asarray(feats), jnp.asarray(caps), case["jcfg"])
    with torch.no_grad():
        got = PSE.enhanced_decoder_apply(
            model.decoder, torch.from_numpy(feats),
            torch.from_numpy(caps).long(), case["pcfg"])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=0)
    own, _ = RP.enhanced_student_from_reference(case["sd"], case["pcfg"],
                                                seed=0)
    assert not np.array_equal(own["decoder"]["query_projection"]["weight"],
                              params["decoder"]["query_projection"]["weight"])
