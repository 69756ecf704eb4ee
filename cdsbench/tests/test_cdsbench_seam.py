"""The substituted target stream answers only what the resident shard
holds, and a run that fell back to the dense pull, or loaded JAX, is
refused its result."""

import types

import pytest
import torch

from cdsbench import run


def _fake_program(width: int = 32):
    shard = types.SimpleNamespace(packed_threshold=20, t_pad=width,
                                  count=width)
    return types.SimpleNamespace(shard=shard, device=torch.device("cpu"),
                                 yields=3)


def _ask(program, **change):
    ask = dict(targets=[None] * 32, device="cpu", pack_threshold=20,
               tile_size=32, plane_kind="keys")
    ask.update(change)
    return list(run.Program._stream(program, **ask))


def test_stream_yields_the_resident_shard():
    program = _fake_program()
    assert _ask(program) == [program.shard] * 3


@pytest.mark.parametrize("change", [
    {"tile_size": 4096}, {"pack_threshold": 0}, {"plane_kind": "packed"},
    {"targets": [None] * 31}])
def test_stream_refuses_what_the_shard_does_not_hold(change):
    with pytest.raises(ValueError, match="resident shard holds"):
        _ask(_fake_program(), **change)


@pytest.mark.parametrize("fallbacks,forbidden,refused", [
    (0, [], False), (1, [], True), (0, ["jax"], True)])
def test_refusal(fallbacks, forbidden, refused):
    result = {"work": {"emit_select_fallbacks": fallbacks}}
    assert (run.refusal(result, forbidden) is not None) == refused
