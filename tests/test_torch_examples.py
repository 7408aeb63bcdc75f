"""The port's examples run on the CPU at a small scale
(``python -m repro_torch.examples.<name> --device cpu``); on the card
they run without ``--device``. ``quickstart`` is exercised in
``test_torch_train.py``; ``train_lm`` trains the smollm smoke LM here."""
import os
import pathlib
import subprocess
import sys

import torch

from repro_torch.examples import hybrid_spmm_demo, serve_gcn

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def test_hybrid_spmm_demo_backends_agree(capsys):
    assert hybrid_spmm_demo.main(["--device", "cpu", "--scale", "0.2"]) \
        < 1e-4
    out = capsys.readouterr().out
    assert "reordering ablation" in out and "labels" in out


def test_serve_gcn_answers_every_request():
    snap = serve_gcn.main(["--device", "cpu", "--scale", "0.05",
                           "--requests", "6", "--rate", "200",
                           "--datasets", "cora,citeseer",
                           "--max-linger-ms", "200"])
    assert snap["completed"] == 6


def test_examples_default_to_the_card():
    """Without ``--device`` an example asks for the card, and without one
    it stops with the device error rather than running on the CPU."""
    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.examples.quickstart", "--scale",
                          "0.05", "--steps", "1"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA device requested" in res.stderr


def test_train_lm_loss_falls(tmp_path):
    """``python -m repro_torch.examples.train_lm --device cpu --steps 6``
    trains the smoke LM through ``TrainingRunner`` (its own assertion:
    the last loss below the first), and a rerun resumes from the final
    checkpoint instead of training again."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.examples.train_lm", "--device",
           "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done at step 6; events: []" in res.stdout
    from repro_torch.examples import train_lm
    losses = train_lm.main(["--device", "cpu", "--steps", "6",
                            "--ckpt-dir", str(tmp_path / "direct")])
    assert len(losses) == 6 and losses[-1] < losses[0]
    res = subprocess.run(cmd[:-2] + ["--steps", "6", "--ckpt-dir",
                                     str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done at step 6; events: [('resume', 6)]" in res.stdout
