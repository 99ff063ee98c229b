"""The ``ci`` preset's spread on the CPU across intra-op thread counts,
in bf16 and in float32: what ``chip_smoke.py``'s ``goldens`` phase sets
its bounds from (twice the spread, relative to the CPU golden).

    python -m art_sbir_tpu_torch.scripts.probe_ci_spread

``cli/goldens.py``'s ``run("ci", ...)`` on the CPU at 1, 2, 4 and 8
threads (one thread and deterministic algorithms are what
``goldens/torch_ci_cpu.json`` and ``torch_ci_f32_cpu.json`` record), each
in a directory of its own. One JSON line a run (final train and test
loss, MRR), then one a precision: each loss's span over the thread
counts, relative to the golden's.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
from pathlib import Path

import torch

from art_sbir_tpu_torch.cli import goldens

THREADS = (1, 2, 4, 8)
ROOT = Path(__file__).resolve().parents[2]


def main() -> dict:
    n, out = torch.get_num_threads(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for bf16 in (True, False):
            tag = "ci" if bf16 else "ci_f32"
            want = json.loads((ROOT / "goldens" / f"torch_{tag}_cpu.json")
                              .read_text())
            runs = {}
            for t in THREADS:
                torch.set_num_threads(t)
                torch.use_deterministic_algorithms(t == 1)
                work = Path(tmp) / f"{tag}_{t}"
                work.mkdir()
                try:
                    with contextlib.chdir(work):
                        g = goldens.run("ci", Path("data"), Path("results"),
                                        0, "cpu", bf16=bf16)
                finally:
                    torch.set_num_threads(n)
                    torch.use_deterministic_algorithms(False)
                runs[t] = {k: g[k] for k in ("final_train_loss",
                                             "final_test_loss", "mrr")}
                print(json.dumps({"golden": tag, "threads": t, **runs[t]}),
                      flush=True)
            span = {}
            for k in ("final_train_loss", "final_test_loss"):
                vals = [r[k] for r in runs.values()]
                span[k] = {"min": min(vals), "max": max(vals),
                           "golden": want[k],
                           "rel_span": (max(vals) - min(vals)) / abs(want[k])}
            out[tag] = span
            print(json.dumps({"golden": tag, "span": span}), flush=True)
    return out


if __name__ == "__main__":
    main()
