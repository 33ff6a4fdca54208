"""`tools/conv_band.py` against the JAX package's tracked five-seed band,
and the port's `epoch_val` records against the JAX runs' records.

The JAX package's five float32 runs of the convergence protocol
(`configs/synthetic.yaml`, B=4, 21 epochs on `data/synthetic_conv`, seeds
42-46) are tracked under `snapshot/conv_r11_band4` and
`snapshot/conv_r13_band4_s43..s46`; `tools/PROFILE_r11.md` published their
band (the mean over epochs 16-20 per run, then mean +- sd over the runs).
The port's runs are compared with them by the same tool, so the port must
write the same records: every key, and the step numbering (an epoch's
record at len(val loader) * epoch - 1).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import conv_band  # noqa: E402

JAX_RUNS = [os.path.join(REPO, "snapshot", d) for d in
            ["conv_r11_band4"] + [f"conv_r13_band4_s{s}" for s in range(43, 47)]]

# tools/PROFILE_r11.md, the band=4 column (mean, sd), three decimals
PUBLISHED = {"mos_iou": (0.617, 0.035), "fb_iou": (0.696, 0.059),
             "ego_rot_error": (0.340, 0.047), "ego_trans_error": (0.065, 0.020),
             "inst_l2_error": (0.191, 0.011)}


def test_conv_band_reproduces_the_published_jax_band(capsys):
    band = conv_band.band(JAX_RUNS)
    for m, (mean, sd) in PUBLISHED.items():
        assert abs(band[m]["mean"] - mean) <= 1e-3, (m, band[m])
        assert abs(band[m]["sd"] - sd) <= 1e-3, (m, band[m])
    # a group against itself: t 0, p 1; the CLI prints the table and one JSON line
    res = conv_band.compare(JAX_RUNS, JAX_RUNS)
    assert all(r["t"] == 0 and r["p"] == pytest.approx(1) for r in res.values())
    assert conv_band.main(JAX_RUNS + ["--vs"] + JAX_RUNS + ["--names", "jax", "jax2"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metrics"]["fb_iou"]["a"]["mean"] == pytest.approx(band["fb_iou"]["mean"])


def test_port_epoch_val_records_match_jax_records(tmp_path):
    """A CPU val epoch of the port's Trainer writes an `epoch_val` record
    with the JAX runs' keys, at len(val loader) * epoch - 1, as the JAX
    runs' records sit at 30 * epoch - 1 over the 30 val samples."""
    from pcaccumulation_tpu_torch import build_model, model_generator
    from pcaccumulation_tpu_torch.train.trainer import Trainer
    from test_torch_train import _tiny_batches, _tiny_cfg

    jax_recs = conv_band.epoch_val_records(JAX_RUNS[0])
    with open(os.path.join(REPO, "data", "synthetic_conv", "val_info.txt")) as f:
        n_val = sum(1 for line in f if line.strip())
    assert [r["step"] for r in jax_recs] == [n_val * e - 1 for e in range(1, 21)]

    cfg = _tiny_cfg()
    batches = _tiny_batches(cfg)
    tr = Trainer(cfg, build_model(cfg, "cpu", model_generator(cfg)), {"val": batches},
                 save_dir=str(tmp_path), device="cpu")
    with torch.no_grad():
        tr.inference_one_epoch(16, "val")
    recs = conv_band.epoch_val_records(str(tmp_path))
    assert len(recs) == 1
    assert set(recs[0]) == set(jax_recs[0])
    assert recs[0]["step"] == len(batches) * 16 - 1
    assert all(np.isfinite(recs[0][m]) for m in conv_band.METRICS)
