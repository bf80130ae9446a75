"""Every architecture config of repro_torch against the JAX reference's:
the registry holds the same arch ids in the same order, and ``get_config``
and ``smoke_config`` of each equal the reference's field for field, the
derived properties included (mamba2-2.7b's smoke config keeps its
``kv_heads`` of 0: the ssm branch derives no head fields).  No tolerance:
configs are data."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as C  # noqa: E402
from repro_torch import configs as TC  # noqa: E402

PROPS = ("vocab_padded", "attention_free", "subquadratic", "d_inner")


def _fields(cfg):
    return {**dataclasses.asdict(cfg), **{p: getattr(cfg, p) for p in PROPS}}


def test_arch_ids_match_reference():
    assert TC.ARCH_IDS == C.ARCH_IDS


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_config_matches_reference(arch, smoke):
    get = "smoke_config" if smoke else "get_config"
    tcfg, jcfg = getattr(TC, get)(arch), getattr(C, get)(arch)
    assert _fields(tcfg) == _fields(jcfg)
    if arch == "mamba2-2.7b":
        assert (tcfg.n_heads, tcfg.kv_heads, tcfg.ssm_state) == ((0, 0, 16) if smoke
                                                                  else (0, 0, 128))
