"""Compare retrieval results across saved runs (reference
`visualization.py:157-194` ``show_compared_topk_accuracy`` and the A/B
workflow over ``results/<run>/inference*.json``).

    python -m art_sbir_tpu_torch.cli.compare run_folder1 run_folder2 ...
        [--results_root results] [--out comparison_topk.png]

Counterpart of ``art_sbir_tpu/cli/compare.py``: the same table on
standard output (MRR, top-1, top-10, mean rank a run) and the grouped
top-k bar chart, which is drawn where matplotlib is installed (otherwise
a note says so). A folder name is looked up under ``--results_root``
first, then taken as a path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path
from typing import Dict

from art_sbir_tpu_torch.viz.plots import compared_topk_bars


def _load_inference(folder: Path) -> Dict:
    for name in ("inference_updated.json", "inference.json"):
        f = folder / name
        if f.is_file():
            d = json.loads(f.read_text())
            # the Kaggle/Mixed two-pass shape: the drawings' stats
            return d.get("drawing_stats", d)
    raise FileNotFoundError(f"no inference json in {folder}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="compare saved retrieval runs")
    p.add_argument("folders", nargs="+")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--out", type=str, default="comparison_topk.png")
    args = p.parse_args(argv)

    root = Path(args.results_root)
    results = {}
    rows = []
    for name in args.folders:
        folder = root / name if (root / name).is_dir() else Path(name)
        stats = _load_inference(folder)
        results[folder.name] = stats["topk_acc"]
        rows.append(
            (folder.name, stats.get("mean_reciprocal_rank", float("nan")),
             stats["topk_acc"][0], stats["topk_acc"][-1],
             stats.get("mean", float("nan"))))

    header = (f"{'run':60s} {'MRR':>8s} {'top1':>7s} {'top10':>7s} "
              f"{'mean rank':>10s}")
    print(header, flush=True)
    for name, mrr, t1, t10, mean_rank in rows:
        print(f"{name:60s} {mrr:8.4f} {t1:7.3f} {t10:7.3f} {mean_rank:10.1f}",
              flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no chart", flush=True)
        return
    out = compared_topk_bars(results, Path(args.out))
    print(f"chart written to {out}", flush=True)


if __name__ == "__main__":
    main()
