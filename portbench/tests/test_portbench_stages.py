"""The stage attribution of a traced window on hand-made records: device
records put down to the ``repro.*`` ranges around the host call that
launched them, idle gaps to the ranges around their middle, and the
readers that take their numbers from it."""
import random

import pytest

import portbench_tiny as tiny
from portbench.harness import profiling as pf
from portbench.harness import spec, stages

RERANK = "void (anonymous namespace)::rerank_slice_kernel<int, 1>(int const*, int*)"
TORCH_EW = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int> >()"
SEARCH = "void at::native::searchsorted_cuda_kernel<long, long>(long*, long const*)"


def _host(name, a, b):
    return pf.Record(name, "cpu", a, b)


def _range(name, a, b):
    return _host(stages.PREFIX + name, a, b)


def _launch(t):
    return _host("cudaLaunchKernel", t, t + 1)


def _dev(name, a, b, kind="kernel"):
    return pf.Record(name, kind, a, b)


def _window(records, batches=1, t0=0.0, t1=1000.0):
    return pf.Window(first_request=0, requests=batches, batches=batches, t0_us=t0, t1_us=t1,
                     records=records, launched={})


def _run(window):
    return type("Run", (), {"profile": window})()


def _bulk_batch():
    """One request of a bulk cell: the host launches phase A's op and the
    tombstone mask early, waits in the rung read and the end-of-batch sync,
    while the card runs the work behind it."""
    return [
        _host("portbench.request", 0, 900),
        _range("engine_request", 0, 900),
        _range("engine_batch", 10, 880),
        _range("phase_a", 20, 300),
        _range("stage_probe_keys", 30, 60), _launch(40),
        _range("rung_read", 60, 300), _host("cudaMemcpyAsync", 61, 299),
        _range("phase_b_rerank", 300, 400),
        _range("stage_tombstone", 310, 340), _launch(320), _launch(330),
        _range("stage_rerank", 340, 360), _launch(350),
        _range("engine_sync", 400, 880),
        _range("engine_answers", 880, 900), _host("cudaMemcpyAsync", 885, 895),
        # the card: each record after its launch, most while the host waits
        _dev(TORCH_EW, 100, 250),
        _dev("Memcpy DtoH (Device -> Pageable)", 250, 255, "gpu_memcpy"),
        _dev(TORCH_EW, 400, 450),
        _dev(SEARCH, 460, 480),
        _dev(RERANK, 480, 870),
        _dev("Memcpy DtoH (Device -> Pageable)", 886, 890, "gpu_memcpy"),
    ]


def test_nested_ranges_attribute_to_the_innermost_and_keep_the_stack():
    st = stages.Stages(_window(_bulk_batch()))
    assert st.linked and st.launch_calls == len(st.device) == 6
    assert st.stacks[0] == ("engine_request", "engine_batch", "phase_a", "stage_probe_keys")
    assert st.stacks[4] == ("engine_request", "engine_batch", "phase_b_rerank", "stage_rerank")
    assert st.device_by_stage() == {"stage_probe_keys": 150.0, "rung_read": 5.0,
                                    "stage_tombstone": 70.0, "stage_rerank": 390.0,
                                    "engine_answers": 4.0}
    assert st.device_us("phase_a") == 155.0
    assert st.device_us("engine_request") == 619.0
    assert st.device_us("stage_dedup") is None          # no such range in the window


def test_a_record_the_card_runs_late_goes_to_its_launch_not_its_time():
    """The tombstone mask's two kernels run while the host sits in
    ``engine_sync``: they still belong to ``stage_tombstone``."""
    st = stages.Stages(_window(_bulk_batch()))
    late = [s for r, s in zip(st.device, st.stacks) if r.start_us in (400, 460)]
    assert [s[-1] for s in late] == ["stage_tombstone", "stage_tombstone"]
    # by their own times they would have gone to the sync
    assert [s[-1] for s in stages._stacks(st.ranges, [400.0, 460.0])] == ["engine_sync"] * 2


def test_the_log_table_always_has_an_unattributed_line():
    lines = stages.Stages(_window(_bulk_batch(), batches=2)).table()
    assert lines[0] == "stages: 10 ranges, 6 device records, 6 launch calls"
    assert "stage device stage_rerank: 0.1950 ms a batch (63.00%)" in lines
    assert "stage device unattributed: 0.0000 ms a batch (0.00%)" in lines
    assert "stage idle outside the program: 0.0550 ms a batch" in lines


def test_a_launch_outside_every_range_is_unattributed():
    recs = _bulk_batch() + [_launch(950), _dev(TORCH_EW, 960, 970)]
    st = stages.Stages(_window(recs, t1=1000.0))
    assert st.linked
    assert st.device_by_stage()[stages.UNATTRIBUTED] == 10.0


def test_counts_that_differ_leave_every_record_unattributed():
    recs = [r for r in _bulk_batch() if not (r.name == "cudaLaunchKernel" and r.start_us == 40)]
    st = stages.Stages(_window(recs))
    assert not st.linked
    assert set(st.device_by_stage()) == {stages.UNATTRIBUTED}
    assert spec.reader(tiny.ROOT, "phase_a_device_ms.bulk")(_run(_window(recs))) is None


def test_idle_gaps_go_to_the_ranges_around_their_middle():
    st = stages.Stages(_window(_bulk_batch(), t1=1000.0))
    assert st.gaps == [(0.0, 100.0), (255.0, 400.0), (450.0, 460.0), (870.0, 886.0),
                       (890.0, 1000.0)]
    assert st.idle_by_stage() == {"stage_probe_keys": 100.0, "stage_tombstone": 145.0,
                                  "engine_sync": 26.0, stages.OUTSIDE: 110.0}
    # the program's own idle: every gap but the one after the request
    assert st.program_idle_us() == 100.0 + 145.0 + 10.0 + 16.0


def test_the_readers_give_hand_computed_values():
    w = _window(_bulk_batch(), batches=2)
    read = {name: spec.reader(tiny.ROOT, name) for name in
            ("phase_a_device_ms.bulk", "tombstone_device_ms.bulk", "program_idle_ms.online")}
    assert read["phase_a_device_ms.bulk"](_run(w)) == pytest.approx(155.0 / 1e3 / 2)
    assert read["tombstone_device_ms.bulk"](_run(w)) == pytest.approx(70.0 / 1e3 / 2)
    assert read["program_idle_ms.online"](_run(w)) == pytest.approx(271.0 / 1e3 / 2)


def test_a_program_without_ranges_gives_nothing_and_does_not_raise():
    """The benchmark's files over a program that opens no ranges."""
    recs = [r for r in _bulk_batch() if not r.name.startswith(stages.PREFIX)]
    for name in ("phase_a_device_ms.bulk", "tombstone_device_ms.bulk",
                 "program_idle_ms.online"):
        assert spec.reader(tiny.ROOT, name)(_run(_window(recs))) is None
        assert spec.reader(tiny.ROOT, name)(_run(None)) is None


def test_a_window_with_no_device_record_gives_nothing():
    recs = [r for r in _bulk_batch() if r.kind == "cpu"]
    for name in ("phase_a_device_ms.bulk", "program_idle_ms.online"):
        assert spec.reader(tiny.ROOT, name)(_run(_window(recs))) is None


def test_the_sweep_equals_the_innermost_ranges_by_brute_force():
    rng = random.Random(7)

    def nest(a, b, depth, out):
        t = a
        while depth < 4 and t < b - 4 and rng.random() < 0.7:
            s = t if t > a and rng.random() < 0.3 else rng.uniform(t, b - 3)  # siblings touch
            e = rng.uniform(s + 1, b)
            out.append(_range(f"s{depth}_{len(out)}", s, e))
            nest(s, e, depth + 1, out)
            t = e
        return out

    ranges = sorted(nest(0.0, 1000.0, 0, []), key=lambda r: (r.start_us, -r.end_us))
    times = [rng.uniform(0, 1000) for _ in range(300)]
    got = stages._stacks(ranges, times)
    for t, stack in zip(times, got):
        around = sorted((r for r in ranges if r.start_us <= t <= r.end_us),
                        key=lambda r: (r.start_us, -r.end_us))
        assert stack == tuple(r.name[len(stages.PREFIX):] for r in around)


def test_records_from_the_profiler_keep_the_programs_ranges_on_the_host():
    """A real (CPU) profile of the program's spans: every ``repro.*`` event
    is a host record, so no device record carries the name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("engine_batch"):
            with obs_trace.span("stage_tombstone"):
                torch.ones(4).add_(1)
    recs = pf.records_from_profiler(prof)
    mine = [r for r in recs if r.name.startswith(stages.PREFIX)]
    assert {r.name for r in mine} == {"repro.engine_batch", "repro.stage_tombstone"}
    assert {r.kind for r in mine} == {"cpu"}
    assert not any(r.kind != "cpu" and r.name.startswith(stages.PREFIX) for r in recs)


def _with_ids(records):
    """The records with the profiler's correlation ids: the n-th launch call
    and the n-th device record (by start) share id 100 + n."""
    calls = sorted((r for r in records if r.kind == "cpu"
                    and r.name.startswith(stages.LAUNCH_CALLS)), key=lambda r: r.start_us)
    dev = sorted((r for r in records if r.kind != "cpu"), key=lambda r: r.start_us)
    for n, (c, d) in enumerate(zip(calls, dev)):
        c.correlation = d.correlation = 100 + n
    return records


def test_correlation_ids_give_the_stacks_launch_order_gives_on_one_stream():
    by_order = stages.Stages(_window(_bulk_batch()))
    st = stages.Stages(_window(_with_ids(_bulk_batch()), batches=2))
    assert st.by_id and st.linked and st.unmatched == 0
    assert st.stacks == by_order.stacks
    assert st.order_agrees == pytest.approx(100.0)
    assert st.table()[0] == ("stages: 10 ranges, 6 device records, 6 launch calls, linked by "
                             "correlation id (0 unmatched); launch order agrees on 100.00% of "
                             "device time")


def test_a_second_stream_runs_out_of_launch_order_and_the_ids_still_link():
    """A collective on a stream of its own (NCCL's) starts before work
    launched earlier on the compute stream: order would swap the two."""
    recs = [_range("query", 0, 300),
            _range("stage_rerank", 10, 30), _host("cudaLaunchKernel", 20, 21),
            _range("exchange", 40, 60), _host("cudaLaunchKernelExC", 50, 51),
            _dev(RERANK, 120, 200), _dev("ncclDevKernel_AllGather_RING_LL", 60, 110)]
    recs[2].correlation, recs[5].correlation = 1, 1
    recs[4].correlation, recs[6].correlation = 2, 2
    st = stages.Stages(_window(recs))
    assert st.device_by_stage() == {"stage_rerank": 80.0, "exchange": 50.0}
    assert st.order_agrees == pytest.approx(0.0)


def test_a_device_record_whose_id_names_no_launch_call_is_unattributed():
    recs = _with_ids(_bulk_batch())
    rerank = next(r for r in recs if r.name == RERANK)
    rerank.correlation = 999
    st = stages.Stages(_window(recs))
    assert st.linked and st.unmatched == 1
    assert st.device_by_stage()[stages.UNATTRIBUTED] == 390.0
    assert "(1 unmatched)" in st.table()[0]
    # one unmatched record does not void the others, as unequal counts do by order
    assert st.device_us("phase_a") == 155.0
