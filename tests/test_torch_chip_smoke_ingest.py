"""`chip_smoke.py`'s buffetfs_ingest phase on the CPU at a small size (256
sample files of train_ssm's 2049 tokens in 4 shard directories): its exact
gates pass over the port's BuffetFS, and an agent that sends one RPC more a
read (a LOOKUP_DIR, or a Lustre-style OPEN_RECORD), or that serves its
permission checks by RPC, fails them.  train_resume's gates on its storage
and its lock nestings name each planted fault."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import core
from repro_torch.core.inode import ROOT_FILE_ID

ROOT = Path(__file__).resolve().parents[1]
FILES, DIRS = 256, 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_buffetfs_ingest_passes_its_gates_at_a_small_size():
    cs = _chip_smoke()
    rec = cs.buffetfs_ingest(torch.device("cpu"), n_files=FILES, n_dirs=DIRS)
    assert cs.ingest_failures(rec) == []
    assert rec["bytes_each"] == [8208] and rec["n_servers"] == 4
    # the files' owner reads them: no permission check costs an RPC
    assert rec["perm_check_rpcs"] == {"warmed": 0, "after_epoch": 0,
                                      "after_open_read_close": 0}
    ep = rec["epoch"]
    # the pipeline's thread reads ahead of the epoch, by at most prefetch + 1
    # batches of io_threads' reads in flight
    assert FILES <= ep["samples_read"] <= FILES + 4 * 8
    assert ep["by_type"] == {"READ": ep["samples_read"], "CLOSE": ep["samples_read"]}
    assert ep["batches"] == FILES // 8 and ep["batches_mismatched"] == 0
    systems = rec["systems"]
    assert {k: (v["critical_per_file"], v["async_per_file"], v["by_type_per_file"])
            for k, v in systems.items()} == {
        "buffetfs": (1.0, 1.0, {"CLOSE": 1.0, "READ": 1.0}),
        "lustre_normal": (2.0, 1.0, {"CLOSE": 1.0, "OPEN_RECORD": 1.0, "READ": 1.0}),
        "lustre_dom": (1.0, 1.0, {"CLOSE": 1.0, "READ_INLINE": 1.0})}
    assert all(v["bad_reads"] == 0 and v["host_wall_us_per_file"] > 0
               for v in systems.values())


def test_write_corpus_writes_what_buffetdataset_build_writes(tmp_path):
    """The ingest corpus's bulk writer: the same paths and bytes, INDEX
    included, as `BuffetDataset.build` in a cluster of its own."""
    import numpy as np
    from repro_torch.data import BuffetDataset
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    samples = [rng.integers(1, 50000, size=int(n)).astype(np.uint32)
               for n in rng.integers(20, 40, size=37)]
    trees = []
    for name in ("build", "bulk"):
        c = core.BuffetCluster(root_dir=str(tmp_path / name), n_servers=4)
        agent = core.BAgent(c)
        lib = core.BLib(agent)
        try:
            if name == "build":
                BuffetDataset.build(lib, samples, name="d", shard_size=16)
            else:
                cs.write_corpus(lib, samples, "d", 16)
            trees.append({p: lib.read_file(p) for p in lib.walk_files("/corpus")})
        finally:
            agent.shutdown()
            c.shutdown()
    assert trees[0] == trees[1] and len(trees[0]) == 37 + 1


def _planted(verb):
    """An agent that sends one `verb` RPC more for every read."""
    class Planted(core.BAgent):
        def read(self, fd, n=-1):
            if verb == "LOOKUP_DIR":
                msg = core.Message(core.MsgType.LOOKUP_DIR, {"file_id": ROOT_FILE_ID})
            else:
                msg = core.Message(core.MsgType.OPEN_RECORD, {
                    "parent": ROOT_FILE_ID, "name": "corpus", "client_id": self.client_id,
                    "pid": 1, "fd": fd})
            try:
                self._rpc(0, msg)
            except OSError:
                pass
            return super().read(fd, n)
    return Planted


@pytest.mark.parametrize("verb", ["LOOKUP_DIR", "OPEN_RECORD"])
def test_buffetfs_ingest_fails_an_agent_that_sends_one_rpc_more_a_read(verb):
    cs = _chip_smoke()
    rec = cs.buffetfs_ingest(torch.device("cpu"), n_files=FILES, n_dirs=DIRS,
                             agent_cls=_planted(verb))
    failures = cs.ingest_failures(rec)
    assert rec["epoch"]["by_type"][verb] == rec["epoch"]["samples_read"]
    assert any(f"{verb} in the epoch" in f for f in failures)
    assert any(f.startswith("critical RPCs") for f in failures)
    assert any(f.startswith("BuffetFS open/read/close per file") for f in failures)


class _RefetchingGroups(core.BAgent):
    """An agent that drops its cached group table and fetches it again
    before every read: a permission check served by RPC."""
    def read(self, fd, n=-1):
        with self._tree_lock:
            self._groups_table = None
        self._group_table()
        return super().read(fd, n)


def test_ingest_failures_name_permission_checks_served_by_rpc():
    cs = _chip_smoke()
    rec = cs.buffetfs_ingest(torch.device("cpu"), n_files=64, n_dirs=2,
                             agent_cls=_RefetchingGroups)
    perm, reads = rec["perm_check_rpcs"], rec["epoch"]["samples_read"]
    assert perm["after_epoch"] - perm["warmed"] == reads
    assert perm["after_open_read_close"] - perm["after_epoch"] == 64
    failures = cs.ingest_failures(rec)
    warm, epoch = perm["warmed"], perm["after_epoch"]
    assert f"perm_check_rpcs moved over the epoch: {warm} -> {epoch}" in failures
    assert (f"perm_check_rpcs moved over the open/read/close pass: {epoch} -> "
            f"{epoch + 64}") in failures


def test_ingest_failures_name_a_missing_close_and_a_wrong_batch():
    cs = _chip_smoke()
    rec = cs.buffetfs_ingest(torch.device("cpu"), n_files=64, n_dirs=2)
    assert cs.ingest_failures(rec) == []
    rec["epoch"]["by_type"]["CLOSE"] -= 1
    rec["epoch"]["batches_mismatched"] = 1
    rec["systems"]["lustre_dom"]["bad_reads"] = 2
    failures = cs.ingest_failures(rec)
    assert len(failures) == 3
    assert failures[0].startswith("CLOSE") and "batches differ" in failures[1]
    assert failures[2].startswith("lustre_dom: 2 of 64")


def test_resume_failures_name_an_open_record_and_a_run_without_rpcs():
    """train_resume's gate on its storage: an OPEN_RECORD in a run, or a run
    that sent no RPC (a client that counts none), fails it."""
    cs = _chip_smoke()
    per_step = {"rmsnorm": 2}
    run = {"start_step": 0, "losses": [1.0], "steps_run": 1,
           "launches": {"rmsnorm": 2}, "critical_rpcs": 5, "async_rpcs": 5,
           "rpcs_by_type": {"READ": 5, "CLOSE": 5}, "lock_pairs": _PAIRS}
    rec = {"stop": 1, "steps": 2, "restored_diff_leaves": [], "batch_diffs": [],
           "batches_compared": 1, "loss_rel_err": [0.0],
           "runs": {"A": dict(run), "B": dict(run, start_step=1), "C": dict(run)}}
    assert cs.resume_failures(rec, per_step) == []
    rec["runs"]["B"]["rpcs_by_type"] = {"READ": 5, "CLOSE": 5, "OPEN_RECORD": 1}
    rec["runs"]["C"]["critical_rpcs"] = 0
    assert cs.resume_failures(rec, per_step) == [
        "run B sent 1 OPEN_RECORD",
        "run C sent no critical RPC: {'READ': 5, 'CLOSE': 5}"]


_PAIRS = [("dir_mutex", "server_lock"), ("file_lock", "server_lock")]


def _resume_rec():
    run = {"start_step": 0, "losses": [1.0], "steps_run": 1,
           "launches": {"rmsnorm": 2}, "critical_rpcs": 5, "async_rpcs": 5,
           "rpcs_by_type": {"READ": 5, "CLOSE": 5}}
    return {"stop": 1, "steps": 2, "restored_diff_leaves": [], "batch_diffs": [],
            "batches_compared": 1, "loss_rel_err": [0.0],
            "runs": {n: dict(run, start_step=int(n == "B"), lock_pairs=list(_PAIRS))
                     for n in "ABC"}}


def test_resume_failures_name_a_lock_inversion_an_unregistered_class_and_no_nesting():
    """train_resume's lock-order gate: a run that nested a server lock
    outside a per-file one, one that nested a lock class the registry does
    not know, and one whose recorder saw no nesting each fail it."""
    cs = _chip_smoke()
    per_step = {"rmsnorm": 2}
    rec = _resume_rec()
    assert cs.resume_failures(rec, per_step) == []
    rec["runs"]["A"]["lock_pairs"] = _PAIRS + [("server_lock", "file_lock")]
    rec["runs"]["B"]["lock_pairs"] = _PAIRS + [("file_lock", "lease_lock")]
    rec["runs"]["C"]["lock_pairs"] = []
    assert cs.resume_failures(rec, per_step) == [
        "run A nested locks against the declared order: [('server_lock', 'file_lock')]",
        "run B nested unregistered lock classes ['lease_lock']",
        "run C recorded no lock nesting"]
