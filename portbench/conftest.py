"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, and the tiny sizes the CPU tests run the cells at.

    python -m pytest portbench/tests -q           # here: the card tests skip
    python3 -m pytest portbench/tests -m card -q  # on the card
"""

import pytest

# the cells at sizes a CPU test holds: every width cut, the paths the same
TINY_CONFIGS = {
    "full_student": {"student": {"embed_size": 32, "hidden_size": 32,
                                 "vocab_size": 60, "image_size": 64},
                     "init": {"calibrate_bn": 16}},
    "vits16_teacher": {"teacher": {"embed_size": 48, "num_heads": 2,
                                   "num_decoder_layers": 2, "encoder_dim": 24,
                                   "encoder_depth": 2, "encoder_heads": 2,
                                   "image_size": 64, "vocab_size": 60}},
}
TINY_TRAFFIC = {
    "full_greedy_b256": {"batch": 4, "pool": 8, "check_images": 8,
                         "trace_calls": 2, "device_calls": 2},
    "full_kd_a2b64": {"batch": 4, "batches": 4, "T": 12, "trace_calls": 1,
                      "device_calls": 1,
                      "captions": {"core": [3, 6], "tail": [7, 9],
                                   "tail_share": 0.2, "zipf": 1.1}},
    "teacher_beam_b512": {"batch": 4, "pool": 8, "check_images": 8,
                          "trace_calls": 1, "device_calls": 1},
}


def tiny(cell: str, dtype: str = None) -> dict:
    """``config_over`` and ``traffic_over`` for ``cell`` at test size;
    ``dtype`` replaces the configurations' compute dtype."""
    import copy
    import json
    from portbench import spec
    over = copy.deepcopy(TINY_CONFIGS)
    for name, c in over.items():
        init = json.load(open(spec.REPO / f"portbench/configs/{name}.json")
                         )["init"]
        c["init"] = {**init, **c.get("init", {})}
        if dtype:
            c["compute_dtype"] = dtype
    return {"config_over": over, "traffic_over": TINY_TRAFFIC[cell]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run on the "
        "card with -m card)")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; the test runs on the card")
    return torch.device("cuda")


@pytest.fixture(name="tiny")
def tiny_fixture():
    return tiny
