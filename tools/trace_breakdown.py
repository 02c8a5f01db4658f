"""Where one dry-run cell's bytes go: rank 0's step traced on fake
tensors (``launch.dryrun.trace_cell``), its recorded aten ops summed by
op and by the role of their outputs (attention score tensors: last dim
the sequence; logits: last dim the vocabulary or its shard).  One JSON
line; no card needed:

    PYTHONPATH=src python3 tools/trace_breakdown.py --arch llama3.2-3b \\
        --shape train_4k [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))


def main(argv=None) -> int:
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import production_shape

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    cfg, shape = get_arch(args.arch), get_shape(args.shape)
    axes = production_shape(args.multi_pod)
    tr, _ = trace_cell(cfg, shape, axes)
    vocab = {cfg.padded_vocab, cfg.padded_vocab // axes["model"]}
    by_op = defaultdict(lambda: [0, 0, 0.0])
    by_role = defaultdict(float)
    for name, shapes, _, flops, nbytes in tr.ops:
        row = by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if any(s and s[-1] in vocab for s in shapes):
            by_role["logits"] += nbytes
        elif any(len(s) >= 4 and s[-1] == shape.seq_len for s in shapes):
            by_role["attention_scores"] += nbytes
        else:
            by_role["other"] += nbytes
    total = tr.bytes_accessed
    top = sorted(by_op.items(), key=lambda kv: -kv[1][2])[:args.top]
    print(json.dumps({
        "arch": cfg.name, "shape": shape.name, "mesh": axes,
        "ops": len(tr.ops), "bytes": total, "flops": tr.flops,
        "kernel_bytes": sum(k.cost.hbm_bytes for k in tr.kernels),
        "by_role_share": {k: v / total for k, v in by_role.items()},
        "top_ops": [{"op": k, "calls": v[0], "flops": v[1], "bytes": v[2],
                     "share": v[2] / total} for k, v in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
