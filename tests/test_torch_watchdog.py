"""The comm watchdog, the elastic restart policy and the hybrid topology of
the port (paddle_tpu_torch/distributed/watchdog.py, fleet/elastic.py,
topology.py) on the CPU: the non-launcher legs of
tests/test_elastic_watchdog.py (:19-90, :130-210) on the port, the race
hammer included, and ``HybridCommunicateGroup`` against the JAX package's
for the same degrees and axis orders (rank lists, coordinates, comm lists
and every ``get_*_parallel_*`` equal)."""

import os
import threading
import time

import pytest

from paddle_tpu_torch.distributed import watchdog as W
from paddle_tpu_torch.distributed.fleet.elastic import (
    ElasticManager, ElasticStatus, HeartbeatWriter, parse_nnodes)
from paddle_tpu_torch.distributed.watchdog import CommTaskManager, comm_watch


def test_watchdog_flags_hung_task():
    mgr = CommTaskManager(scan_interval=0.02)
    fired = []
    mgr.add_handler(lambda t: fired.append(t.name))
    task = mgr.register("fake_all_reduce", "tp", timeout_s=0.1)
    deadline = time.monotonic() + 5.0
    while not (mgr.timed_out and fired) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert task.timed_out
    assert [t.name for t in mgr.timed_out] == ["fake_all_reduce"]
    assert fired == ["fake_all_reduce"]
    assert "test_watchdog_flags_hung_task" in task.start_site
    mgr.shutdown()


def test_watchdog_completed_task_not_flagged():
    mgr = CommTaskManager(scan_interval=0.02)
    task = mgr.register("quick_op", timeout_s=0.2)
    mgr.complete(task)
    time.sleep(0.4)
    assert not mgr.timed_out
    mgr.shutdown()


def test_comm_watch_wraps_a_step():
    mgr = CommTaskManager.instance()
    before = len(mgr.timed_out)
    with comm_watch("manual_step", timeout_s=60) as task:
        pass
    assert task.done and len(mgr.timed_out) == before


def test_watchdog_flags_from_environment(monkeypatch):
    """The port reads the JAX registry's flags from the environment, with
    the registry's defaults."""
    for k in W.FLAG_DEFAULTS:
        monkeypatch.delenv(k, raising=False)
    assert W.flag("FLAGS_comm_timeout_s") == 1800.0
    assert W.flag("FLAGS_comm_abort_on_timeout") is False
    monkeypatch.setenv("FLAGS_comm_timeout_s", "12.5")
    monkeypatch.setenv("FLAGS_nccl_blocking_wait", "1")
    assert W.flag("FLAGS_comm_timeout_s") == 12.5
    assert W.flag("FLAGS_nccl_blocking_wait") is True
    monkeypatch.setenv("FLAGS_comm_timeout_s", "0")
    task = CommTaskManager(scan_interval=0.02).register("off")
    assert task.seq == 0 and task.timeout_s == 0.0


def test_abort_without_a_group_is_a_noop():
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert W.abort_process_group() is False


def test_abort_on_timeout_takes_a_hung_gloo_rank_down(tmp_path):
    """Rank 0 of a two-process gloo group blocks in an all_reduce that
    rank 1 never joins (gloo's own timeout is 30 min): the watchdog flags
    it after 1 s, aborts the group through the torch call named in its
    log, and the process exits with 124.  Gloo's abort returns but leaves
    the blocked call blocked, so the exit does not wait on it."""
    import sys

    from torch.distributed import distributed_c10d as c10d

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_fault_injection import run_hung_collective

    rc, out, err = run_hung_collective(str(tmp_path), "gloo")
    name = "_abort_process_group" if hasattr(c10d, "_abort_process_group") \
        else "destroy_process_group"
    assert rc == 124, err
    assert "task 'hung_all_reduce' hung" in err, err
    assert f"{name} (backend gloo)" in err, err
    assert f"{name} returned" in err, err
    assert "returned" not in out, out


def test_parse_nnodes():
    assert parse_nnodes("2") == (2, 2)
    assert parse_nnodes("2:4") == (2, 4)
    with pytest.raises(ValueError):
        parse_nnodes("4:2")


def test_elastic_decide():
    mgr = ElasticManager(nnodes="1", max_restart=2)
    assert mgr.decide([None, None]) is ElasticStatus.RUNNING
    assert mgr.decide([0, 0]) is ElasticStatus.COMPLETED
    assert mgr.decide([1, None]) is ElasticStatus.RESTART
    assert mgr.decide([0, 7]) is ElasticStatus.RESTART
    assert mgr.restart_count == 2
    assert mgr.decide([1, 0]) is ElasticStatus.ERROR
    reg = ElasticManager(max_restart=1)
    assert reg.register_failure() and not reg.register_failure()


def test_heartbeat_staleness(tmp_path, monkeypatch):
    mgr = ElasticManager(heartbeat_timeout=0.2)
    hb = tmp_path / "hb"
    monkeypatch.setenv("PADDLE_ELASTIC_HEARTBEAT_DIR", str(hb))
    w = HeartbeatWriter(rank=0, interval=0.05).start()
    time.sleep(0.1)
    assert mgr.stale_heartbeats(str(hb)) == []
    w.stop()
    time.sleep(0.4)
    assert mgr.stale_heartbeats(str(hb)) == ["0"]


def test_watchdog_poll_vs_timeout_race_hammer():
    """Tasks with tiny timeouts completed from several threads while the
    scanner expires them: every task ends in exactly one terminal state
    and the handlers fire exactly for the timed-out set."""
    mgr = CommTaskManager(scan_interval=0.002)
    fired = []
    fired_lock = threading.Lock()

    def handler(t):
        with fired_lock:
            fired.append(t.seq)

    mgr.add_handler(handler)
    tasks = []
    tasks_lock = threading.Lock()
    holds = [0.0, 0.03, 0.015]

    def worker(wid):
        for i in range(30):
            t = mgr.register(f"op{wid}_{i}", timeout_s=0.015)
            with tasks_lock:
                tasks.append(t)
            time.sleep(holds[(wid + i) % len(holds)])
            mgr.complete(t)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    deadline = time.monotonic() + 5.0
    while mgr._tasks and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert not mgr._tasks
    for t in tasks:
        assert t.done != t.timed_out, (t.seq, t.done, t.timed_out)
    timed_out = {t.seq for t in tasks if t.timed_out}
    assert {t.seq for t in mgr.timed_out} == timed_out
    with fired_lock:
        assert sorted(fired) == sorted(timed_out)
    assert any(t.done for t in tasks)
    assert any(t.timed_out for t in tasks)
    mgr.shutdown()


def test_watchdog_complete_after_timeout_is_noop():
    mgr = CommTaskManager(scan_interval=0.01)
    task = mgr.register("hung_op", timeout_s=0.03)
    deadline = time.monotonic() + 5.0
    while not task.timed_out and time.monotonic() < deadline:
        time.sleep(0.01)
    assert task.timed_out
    mgr.complete(task)
    assert task.timed_out and not task.done
    mgr.shutdown()


def test_watchdog_disabled_fast_path():
    mgr = CommTaskManager(scan_interval=0.02)
    task = mgr.register("noop", timeout_s=0)
    assert task.seq == 0 and task._stack is None
    mgr.complete(task)
    assert not mgr._tasks
    mgr.shutdown()


# ---------------------------------------------------------------------------
# HybridCommunicateGroup against JAX's
# ---------------------------------------------------------------------------

HCG_CASES = [
    dict(dp_degree=2, mp_degree=2, pp_degree=2),
    dict(sharding_degree=4, mp_degree=2),
    dict(dp_degree=2, sep_degree=2, pp_degree=2),
    dict(dp_degree=8),
    dict(dp_degree=2, mp_degree=2, sharding_degree=2,
         order=["dp", "pp", "sharding", "sep", "mp"]),
    dict(pp_degree=2, sep_degree=2, mp_degree=2,
         order=["mp", "sep", "sharding", "dp", "pp"]),
]

GETTERS = ["get_data_parallel_world_size", "get_model_parallel_world_size",
           "get_pipe_parallel_world_size",
           "get_sharding_parallel_world_size",
           "get_sep_parallel_world_size", "get_data_parallel_rank",
           "get_model_parallel_rank", "get_stage_id",
           "get_sharding_parallel_rank", "get_sep_parallel_rank",
           "get_global_rank", "get_hybrid_group_names", "data_axes"]
GROUPS = ["get_data_parallel_group", "get_model_parallel_group",
          "get_pipe_parallel_group", "get_sharding_parallel_group",
          "get_sep_parallel_group", "get_dp_sep_parallel_group",
          "get_check_parallel_group"]


@pytest.mark.parametrize("kw", HCG_CASES, ids=range(len(HCG_CASES)))
def test_hybrid_communicate_group_matches_jax(kw):
    from paddle_tpu.distributed.topology import \
        HybridCommunicateGroup as JHCG
    from paddle_tpu_torch.distributed.topology import \
        HybridCommunicateGroup as THCG

    j, t = JHCG(**kw), THCG(**kw)
    for g in GETTERS:
        assert getattr(t, g)() == getattr(j, g)(), g
    for g in GROUPS:
        a, b = getattr(t, g)(), getattr(j, g)()
        assert (a.axes, a.nranks, a.name) == (b.axes, b.nranks, b.name), g
    jt, tt = j.topology, t.topology
    assert tt.world_size() == jt.world_size()
    names = jt.get_hybrid_group_names()
    assert tt.get_hybrid_group_names() == names
    for axis in names:
        assert tt.get_dim(axis) == jt.get_dim(axis)
        assert tt.get_comm_list(axis) == jt.get_comm_list(axis)
        for i in range(jt.get_dim(axis)):
            assert tt.get_axis_list(axis, i) == jt.get_axis_list(axis, i)
    for r in range(jt.world_size()):
        c = jt.get_coord(r)
        assert tt.get_coord(r) == c
        assert tt.get_rank(**c) == jt.get_rank(**c) == r
    assert dict(t.mesh.shape) == {a: int(n) for a, n in
                                  zip(j.mesh.axis_names,
                                      j.mesh.devices.shape)}
    assert repr(t) == repr(j)


def test_hybrid_group_ranks_at_another_rank():
    """The port's group of a non-zero rank: the ranks that share its other
    coordinates (the comm list holding it)."""
    from paddle_tpu_torch.distributed.topology import HybridCommunicateGroup

    hcg = HybridCommunicateGroup(dp_degree=2, mp_degree=2, pp_degree=2,
                                 rank=5)
    assert hcg.get_global_rank() == 5
    for axis in ("dp", "mp", "pp"):
        lists = hcg.topology.get_comm_list(axis)
        want = next(g for g in lists if 5 in g)
        assert hcg.axis_group(axis).ranks == want
    with pytest.raises(ValueError, match="permutation"):
        HybridCommunicateGroup(order=["dp", "mp"])
    assert os.environ.get("PADDLE_ELASTIC_HEARTBEAT_DIR") is None
