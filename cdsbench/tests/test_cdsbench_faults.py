"""A run with the timed path broken underneath comes out not correct:
an answer altered where it is produced, and half of each batch left
out."""

import dataclasses

import pytest

from cdsbench.tests.tiny_cell import SEEDS, run_tiny


@pytest.fixture
def engine_cls():
    from colormipsearch_tpu_torch.engine import cds
    return cds.CDSearchEngine


def test_altered_answer_is_caught(monkeypatch, engine_cls):
    emit = engine_cls._emit_matches

    def altered(self, *a, **kw):
        out = emit(self, *a, **kw)
        return [dataclasses.replace(m, matching_pixels=m.matching_pixels
                                    + 1) if i == 0 else m
                for i, m in enumerate(out)]

    monkeypatch.setattr(engine_cls, "_emit_matches", altered)
    res = run_tiny(SEEDS[5])
    assert res["correct"] is False
    assert res["checks"]["mismatched_matches"]["value"] > 0


def test_half_of_the_batch_left_out_is_caught(monkeypatch, engine_cls):
    score = engine_cls._score_batch

    def half(self, batch, *a, **kw):
        return score(self, batch[:max(1, len(batch) // 2)], *a, **kw)

    monkeypatch.setattr(engine_cls, "_score_batch", half)
    res = run_tiny(SEEDS[6])
    assert res["correct"] is False
    assert res["checks"]["mismatched_matches"]["value"] > 0
