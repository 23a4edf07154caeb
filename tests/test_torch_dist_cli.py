"""The CLI's ``--dp_devices 2`` and ``--mesh_devices 2 --dist_impl gspmd``
under ``torchrun`` (2 gloo ranks on the CPU, one shard a rank): rank 0
alone prints the record, equal to the one-process run's to 1e-6, and
writes ``--checkpoint_dir``. (The minibatch run is one epoch: its 150
steps each all-reduce over gloo.)"""

import json

import pytest
from test_torch_halo_dist import last_record, torchrun_cli

from ggad_tpu_torch.cli import main as cli_main


@pytest.mark.parametrize("argv", [
    ["--dataset", "dgraphfin", "--synthetic_scale", "0.005", "--model",
     "ggad-minibatch", "--num_epoch", "1", "--device", "cpu",
     "--dp_devices", "2"],
    ["--dataset", "photo", "--synthetic_scale", "0.05", "--embedding_dim",
     "16", "--num_epoch", "3", "--device", "cpu", "--mesh_devices", "2",
     "--dist_impl", "gspmd"]], ids=["dp_devices", "gspmd"])
def test_cli_under_torchrun_matches_one_process(capsys, tmp_path, argv):
    """``--dp_devices 2`` and ``--mesh_devices 2 --dist_impl gspmd`` under
    ``torchrun`` (2 gloo ranks, one shard a rank): rank 0 alone prints
    the record, equal to the one-process run's, and writes the
    checkpoints."""
    ck = tmp_path / "ck"
    proc = torchrun_cli(argv + ["--checkpoint_dir", str(ck)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert any(p.name.startswith("ckpt_") for p in ck.iterdir())
    records = [line for line in proc.stdout.splitlines()
               if line.startswith("{")]
    assert len(records) == 1
    got = json.loads(records[0])
    cli_main(argv)
    local = last_record(capsys.readouterr().out)
    assert got.keys() == local.keys()
    for k in ("auc", "ap", "test_auc", "test_ap", "best_val_auc"):
        if k in local:
            assert got[k] == pytest.approx(local[k], abs=1e-6), k
