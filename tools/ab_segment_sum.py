"""A/B on one card, in one process: `ops/segment.py::masked_segment_sum`
as the port has it (`index_put_` with accumulate: sorted, no atomics, the
same bits every call) against `index_add_` (float atomics), in the serving
step (the test forward, ICP off) and the val forward, at the default
config in float32 and the nuScenes preset in bf16; torch's seeded init,
calibrated heads, B=1; order A B B A, 5 timed forwards (CUDA events) each
after a warm-up.

    python3 tools/ab_segment_sum.py
"""
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
import pcaccumulation_tpu_torch as port
from pcaccumulation_tpu_torch.config import load_config
from pcaccumulation_tpu_torch.data.loader import collate
from pcaccumulation_tpu_torch.kernels import build
from pcaccumulation_tpu_torch.ops import segment
from pcaccumulation_tpu_torch.models import pillar_encoder, tpointnet
from pcaccumulation_tpu_torch.profile_forward import calibrate_heads, default_scenes


def add_(data, segment_ids, valid, num_segments):
    """masked_segment_sum with index_add_ (float atomics)."""
    masked = data * segment._rows(valid, data).to(data.dtype)
    out = data.new_zeros((num_segments + 1,) + data.shape[1:])
    out.index_add_(0, segment._safe_ids(segment_ids, num_segments), masked)
    return out[:num_segments]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    put_ = segment.masked_segment_sum
    for path, ov in ((None, []), ("configs/nuscene.yaml", ["--train.ckpt_backend=pickle"])):
        cfg = load_config(path, ov)
        cfg["pose_estimation"]["deterministic_sampling"] = True
        batches = [port.to_device(collate([s])) for s in default_scenes(cfg, 2)]
        torch.manual_seed(0)
        model = port.build_model(cfg)
        calibrate_heads(model, batches[0])
        for mode in ("test", "val"):
            res = {"index_put_": [], "index_add_": []}
            for name in ("index_put_", "index_add_", "index_add_", "index_put_"):
                for mod in (segment, pillar_encoder, tpointnet):
                    mod.masked_segment_sum = put_ if name == "index_put_" else add_
                with torch.inference_mode():
                    model(batches[0], mode=mode)
                    for i in range(5):
                        s = torch.cuda.Event(enable_timing=True)
                        e = torch.cuda.Event(enable_timing=True)
                        torch.cuda.synchronize()
                        s.record()
                        model(batches[i % 2], mode=mode)
                        e.record()
                        torch.cuda.synchronize()
                        res[name].append(s.elapsed_time(e))
            for mod in (segment, pillar_encoder, tpointnet):
                mod.masked_segment_sum = put_
            print(f"{path or 'configs/default.yaml'} {mode}: " + "; ".join(
                f"{k} median {statistics.median(v):.3f} ms ({', '.join(f'{t:.3f}' for t in v)})"
                for k, v in res.items()) + f" on {smi}", flush=True)


if __name__ == "__main__":
    main()
