"""The traced window's arithmetic on hand-made device records, and the guard
against a profiler that lost records."""
import pytest

import portbench_tiny as tiny  # noqa: F401
from portbench.harness import profiling as pf
from portbench.harness import program
from portbench.harness.readers import kernels_per_batch


def _window(records, launched, t0=0.0, t1=100.0, batches=2):
    return pf.Window(first_request=0, requests=batches, batches=batches, t0_us=t0, t1_us=t1,
                     records=records, launched=launched)


def _rec(name, a, b, kind="kernel"):
    return pf.Record(name, kind, a, b)


RERANK = "void (anonymous namespace)::rerank_slice_kernel<int, 1>(int const*, int*)"
GATHER = "void (anonymous namespace)::gather_kernel(int const*, int const*)"
TORCH_GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*, char*)"


def test_busy_is_the_union_of_device_records_inside_the_window():
    w = _window([_rec(RERANK, 10, 30), _rec(GATHER, 20, 40), _rec("Memcpy HtoD", 50, 60,
                 "gpu_memcpy"), _rec("aten::sort", 0, 90, "cpu"), _rec(RERANK, 95, 120)],
                {"fused_rerank": 2, "fused_probe_gather": 1})
    assert w.busy_s == pytest.approx((30 + 10 + 5) / 1e6)
    assert w.window_s == pytest.approx(100 / 1e6)
    assert w.kernel_s(("rerank_slice_kernel",)) == pytest.approx(45 / 1e6)
    assert w.kernel_count(("gather_kernel",)) == 1
    assert w.kernel_count() == 3


def test_torchs_own_gather_is_not_the_ports():
    w = _window([_rec(TORCH_GATHER, 0, 5), _rec(GATHER, 5, 6)], {})
    assert w.kernel_count(("gather_kernel",)) == 1
    assert pf.short_name(GATHER) == "gather_kernel"
    assert pf.short_name(RERANK) == "rerank_slice_kernel"


def test_idle_gaps_are_named_by_the_host_operation_around_them():
    w = _window([_rec(GATHER, 10, 20), _rec(GATHER, 60, 70),
                 _rec("portbench.request", 0, 100, "cpu"), _rec("aten::nonzero", 25, 55, "cpu")],
                {"fused_probe_gather": 2})
    gaps = w.idle_gaps(2)
    assert gaps[0] == ("aten::nonzero", pytest.approx(40 / 1e6))
    assert gaps[1] == ("portbench.request", pytest.approx(30 / 1e6))
    assert kernels_per_batch(type("R", (), {"profile": w})()) == 1.0


def test_the_fullest_complete_window_is_kept():
    lossy = _window([_rec(RERANK, 0, 1)], {"fused_rerank": 2})
    small = _window([_rec(RERANK, 0, 1)], {"fused_rerank": 1})
    full = _window([_rec(RERANK, 0, 1), _rec(RERANK, 2, 3), _rec(GATHER, 3, 4)],
                   {"fused_rerank": 2, "fused_probe_gather": 1})
    assert pf.keep_fullest([lossy, small, full], program.KERNELS) is full
    assert lossy.missing == {"fused_rerank": 1}


def test_every_window_lossy_fails_the_traced_run():
    lossy = [_window([_rec(RERANK, 0, 1)], {"fused_rerank": 10}) for _ in range(3)]
    with pytest.raises(pf.LossyTrace, match="lost device records"):
        pf.keep_fullest(lossy, program.KERNELS)


def test_union_clips_and_merges():
    assert pf.union_us([(0, 10), (5, 20), (30, 40), (35, 38)], 2, 36) == 8 + 10 + 6


class _Event:
    """Shaped as torch's ``_KinetoEvent``: what the reader calls, and no
    ``activity_type()`` (torch 2.11 has none)."""

    def __init__(self, name, device, start_ns, duration_ns, correlation=0):
        self._name, self._device = name, device
        self._start, self._dur = start_ns, duration_ns
        self._corr = correlation

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr


def test_profiler_events_are_read_by_where_they_ran_and_their_name():
    events = [_Event("portbench.request", "CPU", 0, 100_000),
              _Event("portbench.request", "CUDA", 1_000, 90_000),
              _Event("aten::sort", "CPU", 2_000, 3_000),
              _Event("cudaLaunchKernel", "CPU", 5_000, 1_000, correlation=7),
              _Event(RERANK, "CUDA", 10_000, 20_000, correlation=7),
              _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 40_000, 2_000),
              _Event("Memset (Device)", "CUDA", 50_000, 500)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    got = pf.records_from_profiler(prof)
    assert [(r.name, r.kind) for r in got] == [
        ("portbench.request", "cpu"), ("aten::sort", "cpu"), ("cudaLaunchKernel", "cpu"),
        (RERANK, "kernel"), ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
        ("Memset (Device)", "gpu_memset")]
    assert (got[3].start_us, got[3].end_us) == (10.0, 30.0)
    assert (got[2].correlation, got[3].correlation, got[1].correlation) == (7, 7, 0)
    assert pf.window_bounds(got, "portbench.request") == (0.0, 100.0)


def test_a_device_copy_of_a_host_range_is_no_device_work():
    """torch.distributed's ``nccl:all_gather`` range on the host has a copy
    on the card spanning the collective's kernel: only the kernel counts."""
    events = [_Event("nccl:all_gather", "CPU", 0, 5_000, correlation=3),
              _Event("cudaLaunchKernelExC", "CPU", 1_000, 1_000, correlation=4),
              _Event("nccl:all_gather", "CUDA", 9_000, 12_000, correlation=3),
              _Event("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                     "CUDA", 10_000, 10_000, correlation=4)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    got = pf.records_from_profiler(prof)
    assert [(r.name[:22], r.kind, r.correlation) for r in got] == [
        ("nccl:all_gather", "cpu", 3), ("cudaLaunchKernelExC", "cpu", 4),
        ("ncclDevKernel_AllGathe", "kernel", 4)]


def test_the_readers_kernel_names_come_from_the_programs_table():
    from portbench.harness import readers
    assert readers.RERANK_KERNELS == ("rerank_slice_kernel", "merge_slices_kernel")
    assert readers.GATHER_KERNELS == ("gather_kernel",)
    # a slice merge is not counted against the rerank's launches
    w = _window([_rec(RERANK, 0, 1), _rec("void merge_slices_kernel(int*)", 1, 2)],
                {"fused_rerank": 1})
    assert pf.keep_fullest([w], program.KERNELS) is w
    assert w.kernel_s(readers.RERANK_KERNELS) == pytest.approx(2 / 1e6)
