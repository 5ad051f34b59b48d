"""The trace's reductions on a hand-made trace, and the steps a request
runs at."""

import pytest
import torch

from perfbench import devtrace, manifest


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dev(ts, dur, stream, name="k"):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"stream": stream}}


def _call(ts, dur, name):
    return {"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": dur,
            "name": name}


def test_busy_overlap_and_idle_gaps_of_a_hand_made_trace():
    # microseconds: stream 7 busy [0, 100) and [150, 200), stream 9
    # [50, 120): busy 170, overlap 50; gaps [120, 150) with the host in a
    # sync, [200, 300) with the host in no CUDA call
    events = [_dev(0, 100, 7, "a"), _dev(50, 70, 9, "b"),
              _dev(150, 50, 7, "a"), _dev(300, 10, 7, "a"),
              _call(110, 60, "cudaStreamSynchronize"),
              _call(125, 5, "cudaLaunchKernel"),
              {"ph": "X", "cat": "cpu_op", "ts": 210, "dur": 80,
               "name": "aten::mm"}]
    s = devtrace.summarize(events, window_s=400e-6)
    assert s.busy_s == pytest.approx(180e-6)
    assert s.overlap_s == pytest.approx(50e-6)
    assert s.device_s_by_name == pytest.approx({"a": 160e-6, "b": 70e-6})
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps[devtrace.NO_CALL] == pytest.approx(100e-6)
    edges = [v for k, v in gaps.items() if k.startswith("window edges")]
    assert edges == [pytest.approx(90e-6)]
    assert [v for _, v in s.idle_gaps] == sorted(
        [v for _, v in s.idle_gaps], reverse=True)


@pytest.mark.parametrize("rows,want", [
    (1, [1024]), (1024, [1024]), (1025, [2048]), (8192, [8192]),
    (8193, [8192, 1024]), (20000, [8192, 8192, 4096]),
    (32768, [8192] * 4)])
def test_the_dense_engine_steps_follow_the_ladder(rows, want):
    tr = manifest.traffic("offline-packed")
    assert manifest.engine("dense").steps(rows, tr) == want
