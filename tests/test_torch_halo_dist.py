"""The ``"dist"`` communicator against the local one: 2 and 4 gloo ranks
on the CPU (``torch.multiprocessing`` spawn), one shard a rank
(``tests/torch_halo_dist_worker.py``).

Each rank computes its shard of ``spmm_halo_bcsr`` and the gradient of a
sharded loss, then one step of ``FullBatchTrainer(mesh=...)``; the test
holds them against the same computation over all shards in this process:
outputs, the sharded gradient and the losses to 1e-6, every parameter's
gradient and the parameters after the step to 1e-5. A replicated
parameter's gradient all-reduced once too often would be D times too
large and shows in the gradients (Adam's first step would hide it in the
parameters).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.multiprocessing as mp

import torch_halo_dist_worker as worker
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world,schedule", [(2, "dense"), (4, "ring"),
                                            (4, "sched")])
def test_dist_ranks_match_the_local_mesh(tmp_path, world, schedule):
    mp.spawn(worker.run, args=(world, free_port(), schedule, str(tmp_path)),
             nprocs=world, join=True)
    mesh = make_mesh(world, comm="local", device="cpu")
    out, grad = worker.spmm_case(mesh, schedule)
    step = worker.step_case(mesh, schedule)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        torch.testing.assert_close(got["spmm"][0], out[r], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got["spmm_grad"][0], grad[r], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got["losses"], step["losses"], rtol=1e-6,
                                   atol=1e-6)
        for key in ("grads", "params"):
            assert got[key].keys() == step[key].keys()
            for k, v in step[key].items():
                torch.testing.assert_close(got[key][k], v, rtol=1e-5,
                                           atol=1e-5, msg=f"{key} {k}")
        torch.testing.assert_close(got["scores"], step["scores"], rtol=1e-5,
                                   atol=1e-5)


def torchrun_cli(argv, nproc=2):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", "ggad_tpu_torch.cli", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def last_record(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_under_torchrun_matches_the_local_mesh(capsys):
    """``--mesh_devices 2`` under ``torchrun`` (2 gloo ranks, one shard a
    rank) prints rank 0's record, equal to the one-process run's."""
    argv = ["--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "16", "--num_epoch", "3", "--device", "cpu",
            "--mesh_devices", "2"]
    proc = torchrun_cli(argv)
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
    assert len(records) == 1       # rank 0 alone prints it
    cli_main(argv)
    local = last_record(capsys.readouterr().out)
    assert records[0]["n_shards"] == local["n_shards"] == 2
    assert records[0]["auc"] == pytest.approx(local["auc"], abs=1e-6)
    assert records[0]["ap"] == pytest.approx(local["ap"], abs=1e-6)


def test_cli_under_torchrun_checkpoints_from_rank_0(tmp_path, capsys,
                                                    monkeypatch):
    """Checkpoints under ``torchrun``: rank 0 alone writes and prunes the
    shared directory (5 epochs, a checkpoint each, so the pruning runs),
    the run ends with the newest three and the one-process run's record,
    and a resumed run reads them back. ``--retries`` is refused there."""
    argv = ["--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "16", "--eval_every", "1", "--device", "cpu",
            "--mesh_devices", "2"]
    ck = tmp_path / "ck"
    proc = torchrun_cli(argv + ["--num_epoch", "5", "--checkpoint_dir",
                                str(ck)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(ck)) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    cli_main(argv + ["--num_epoch", "5", "--checkpoint_dir",
                     str(tmp_path / "local")])
    local = last_record(capsys.readouterr().out)
    got = last_record(proc.stdout)
    assert got["auc"] == pytest.approx(local["auc"], abs=1e-6)
    assert got["ap"] == pytest.approx(local["ap"], abs=1e-6)
    # resume past the last checkpoint: epochs 5 and 6, equal to 7 at once
    proc = torchrun_cli(argv + ["--num_epoch", "7", "--checkpoint_dir",
                                str(ck)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(ck)) == ["ckpt_4.pt", "ckpt_5.pt", "ckpt_6.pt"]
    cli_main(argv + ["--num_epoch", "7"])
    whole = last_record(capsys.readouterr().out)
    resumed = last_record(proc.stdout)
    assert resumed["auc"] == pytest.approx(whole["auc"], abs=1e-6)
    assert resumed["ap"] == pytest.approx(whole["ap"], abs=1e-6)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="retries"):
        cli_main(argv + ["--num_epoch", "1", "--retries", "1"])
