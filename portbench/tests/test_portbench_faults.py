"""``correct`` comes out false when the timed path is broken underneath, once
for each fault a cell of this benchmark can have, and for the control (the
reference with its bucket quantisation in bfloat16 put in the program's
place).  The harness runs on the CPU here: only its look for a card is
skipped."""
import copy

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from portbench.reference import lsh as ref
from repro_torch.core import segments
from repro_torch.kernels import ops
from repro_torch.serve import engine as eng


def test_sound_run_is_correct():
    assert tiny.run()["correct"] is True


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = ops.fused_rerank

    def altered(dataset, queries, ids, k, chunk=512):
        d, i = real(dataset, queries, ids, k, chunk=chunk)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % dataset.shape[0]
        return d, i

    monkeypatch.setattr(ops, "fused_rerank", altered)
    res = tiny.run()
    assert res["correct"] is False
    assert res["checks"]["mismatched_queries"]["value"] >= 1


def test_half_of_the_batch_left_out(monkeypatch):
    real = segments.SegmentedIndex.query_compact

    def half(self, queries, *args, **kw):
        q = queries.shape[0]
        d, i, used = real(self, queries[: q // 2], *args, **kw)
        return torch.cat([d, d]), torch.cat([i, i]), used

    monkeypatch.setattr(segments.SegmentedIndex, "query_compact", half)
    res = tiny.run()
    assert res["correct"] is False
    assert res["checks"]["mismatched_queries"]["value"] > 0


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    real = eng.AnnServingEngine.query_batch
    first = {}

    def stale(self, queries):
        if "answer" not in first:
            first["answer"] = real(self, queries)
        return copy.deepcopy(first["answer"])

    monkeypatch.setattr(eng.AnnServingEngine, "query_batch", stale)
    res = tiny.run()
    assert res["correct"] is False


def test_a_request_that_raises_counts_its_queries_as_mismatched(monkeypatch):
    def broken(self, queries):
        raise RuntimeError("the card went away")

    real = eng.AnnServingEngine.query_batch
    calls = {"n": 0}

    def sometimes(self, queries):
        calls["n"] += 1
        return real(self, queries) if calls["n"] <= 1 else broken(self, queries)

    monkeypatch.setattr(eng.AnnServingEngine, "query_batch", sometimes)
    res = tiny.run()
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["mismatched_queries"]["value"] >= tiny.TRAFFIC["serve"]["batch_size"]


@pytest.mark.parametrize("seed", [101, 102, 103])
def test_the_control_fails(monkeypatch, seed):
    """The reference in bfloat16 quantisation, serving in the engine's place."""
    def control(self, queries):
        q = torch.from_numpy(np.asarray(queries, np.int32))
        st = self.index.segments[0].state
        p = st.params
        params = ref.HashParams(float(self.cfg.width), p.walks.pairs, p.offsets, p.mix_a,
                                p.mix_c)
        key = id(self)
        if key not in tables:
            tables[key] = ref.build(params, st.dataset, self.cfg.num_probes,
                                    quant_dtype=torch.bfloat16)
        d, i = ref.answer(params, tables[key], st.dataset, q, self.cfg.candidate_cap,
                          self.cfg.k, quant_dtype=torch.bfloat16)
        return d.numpy(), i.numpy()

    tables = {}
    monkeypatch.setattr(eng.AnnServingEngine, "query_batch", control)
    res = tiny.run(seed=seed)
    assert res["correct"] is False
    assert res["checks"]["mismatched_queries"]["value"] > 0
