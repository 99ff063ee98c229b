"""Pipeline goldens: the whole train -> embed -> rank -> report loop on a
seeded synthetic Sketchy corpus, recorded as a regression golden.

    python -m art_sbir_tpu_torch.cli.goldens --preset learn
    python -m art_sbir_tpu_torch.cli.goldens --preset ci --device cpu

Counterpart of ``art_sbir_tpu/cli/goldens.py``, with its six presets
field for field:

* ``scale`` -- a 5,606-photo gallery and 7,500 query sketches (25
  classes x 300 photos x 2 sketches, split 0.5) at 224 px, one epoch.
* ``ci`` -- a miniature corpus (the whole RN50 at 64 px on 12 photos);
  with ``--device cpu`` it records ``goldens/torch_ci_cpu.json``, which
  ``tests/test_torch_goldens.py`` reproduces bit for bit.
* ``learn`` -- the learnable corpus (each sketch a line drawing of its
  photo), the flagship recipe from scratch at lr 1e-4 for 12 epochs with
  a retrieval evaluation after each: the golden's final MRR must reach
  10x the random-ranking expectation ``(ln N + gamma) / N``.
* ``scale_learn`` -- the scale corpus, learnable, at 224 px, 2 epochs.
* ``vae_ci``, ``gan_ci`` -- seeded loss trajectories of
  ``cli/photo2sketch.py`` and ``cli/pix2pix.py`` on a CPU-sized corpus.

Every preset runs the stock CLIs (``cli/train.main``,
``cli/photo2sketch.main``, ``cli/pix2pix.main``) with JAX's argv plus
``--device``; no precision flag is passed, so each CLI's default applies
(bf16 for the triplet trainer, float32 for the other two), unless
``--no-bf16`` asks the triplet trainer for IEEE float32 (TF32 off). The
default output is ``goldens/torch_<preset>_<cpu|cuda>.json``, and
``goldens/torch_<preset>_f32_<cpu|cuda>.json`` under ``--no-bf16``: the
port never writes the JAX package's ``goldens/<preset>_<backend>.json``.
A golden recorded on the card also holds the card's name and power limit
(``device_name``, ``power_limit``), which its wall times stand beside.
With ``--device cpu`` the ``*_ci`` presets first pin what makes a CPU run
repeat bit for bit (:func:`pin_ci_environment`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path

import torch

from art_sbir_tpu_torch.core.device import card_fields

PRESETS = {
    "scale": dict(n_classes=25, photos_per_class=300, sketches_per_photo=2,
                  split_ratio=0.5, image_size=224, batch_size=32, epochs=1),
    "ci": dict(n_classes=3, photos_per_class=4, sketches_per_photo=2,
               split_ratio=0.5, image_size=64, batch_size=4, epochs=1),
    # lr 1e-4, not the reference's finetuning 1e-5: this trains from scratch
    "learn": dict(n_classes=10, photos_per_class=100, sketches_per_photo=2,
                  split_ratio=0.5, image_size=128, batch_size=32, epochs=12,
                  learnable=True, gen_size=128, learning_rate=1e-4,
                  eval_every_epoch=True),
    "scale_learn": dict(n_classes=25, photos_per_class=300,
                        sketches_per_photo=2, split_ratio=0.5,
                        image_size=224, batch_size=32, epochs=2,
                        learnable=True, gen_size=224, learning_rate=1e-4,
                        eval_every_epoch=True),
}

GENERATIVE_PRESETS = {
    "vae_ci": dict(
        cli="photo2sketch",
        corpus=dict(n_classes=2, photos_per_class=2, with_svg=True),
        argv=["--setup", "Sketchy", "--batchsize", "4", "--max_epoch", "2",
              "--save_rate", "2", "--size", "1.0", "--dec_rnn_size", "32",
              "--z_size", "8", "--num_mixture", "3", "--img_format", "svg"],
        loss_keys=("total_loss", "kl_loss", "reconstruction_loss"),
    ),
    "gan_ci": dict(
        cli="pix2pix",
        corpus=dict(n_classes=2, photos_per_class=2),
        argv=["--mode", "train", "-b", "4", "-e", "2",
              "--dataset", "SketchyPix2Pix", "--image_size", "64",
              "--ngf", "8", "--ndf", "8", "-s", "1.0"],
        loss_keys=("G_GAN", "G_L1", "D_real", "D_fake"),
    ),
}

EULER_GAMMA = 0.5772156649


def chance_mrr(n: int) -> float:
    """The random-ranking MRR expectation over ``n`` rows, H_N / N ~
    (ln N + gamma) / N: the yardstick of the learn contracts."""
    return (math.log(n) + EULER_GAMMA) / n


def ensure_corpus(root: Path, preset: dict) -> Path:
    """The preset's seeded synthetic Sketchy corpus under ``root/sketchy``,
    generated unless its marker file records the same corpus fields.
    Another preset's corpus there is removed first: generating over it
    would leave its extra classes and photos behind (``scale_learn``'s 25
    classes under ``learn``'s 10-class head)."""
    import shutil

    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy

    sk = root / "sketchy"
    marker = sk / ".goldens_corpus.json"
    want = {k: preset.get(k) for k in
            ("n_classes", "photos_per_class", "sketches_per_photo",
             "learnable", "gen_size")}
    if marker.is_file() and json.loads(marker.read_text()) == want:
        return sk
    if sk.exists():
        shutil.rmtree(sk)
    make_synthetic_sketchy(sk, n_classes=preset["n_classes"],
                           photos_per_class=preset["photos_per_class"],
                           sketches_per_photo=preset["sketches_per_photo"],
                           size=preset.get("gen_size", 96),
                           learnable=preset.get("learnable", False))
    marker.write_text(json.dumps(want))
    return sk


def _device_fields(device) -> dict:
    """``backend`` ("cpu" or "cuda") and, on the card, its name and power
    limit."""
    return {"backend": torch.device(device).type, **card_fields(device)}


def run(preset_name: str, root: Path, results_root: Path, seed: int = 0,
        device: str = "cuda", bf16: bool = True) -> dict:
    """Drive ``cli/train.main`` through the preset (``bf16`` False: with
    ``--no-bf16``); returns the golden."""
    from art_sbir_tpu_torch.cli import train as train_cli

    preset = PRESETS[preset_name]
    t0 = time.perf_counter()
    ensure_corpus(root, preset)
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    argv = [
        "-e", str(preset["epochs"]),
        "-b", str(preset["batch_size"]),
        "-d", "SketchyV2",
        "--model_type", "ModifiedResNet_with_classification",
        "--num_classes", str(preset["n_classes"]),
        "--data_root", str(root / "sketchy"),
        "--image_size", str(preset["image_size"]),
        "--split_ratio", str(preset["split_ratio"]),
        "--results_root", str(results_root),
        "--seed", str(seed),
        "--inference",
    ]
    if "learning_rate" in preset:
        argv += ["-l", str(preset["learning_rate"])]
    if preset.get("eval_every_epoch"):
        argv += ["--eval_every_epoch"]
    if "width" in preset:
        argv += ["--width", str(preset["width"])]
    if "layers" in preset:
        argv += ["--layers"] + [str(x) for x in preset["layers"]]
    if not bf16:
        argv += ["--no-bf16"]
    argv += ["--device", str(device)]
    out_path = train_cli.main(argv)
    t_pipeline = time.perf_counter() - t0

    inference = json.loads((out_path / "inference.json").read_text())
    training = json.loads((out_path / "training.json").read_text())
    data_params = json.loads((out_path / "data_params.json").read_text())

    stats = inference.get("drawing_stats", inference)
    n = int(stats["size"])
    return {
        "preset": preset_name,
        **({} if bf16 else {"precision": "float32"}),
        **_device_fields(device),
        "seed": seed,
        "config": preset,
        "n_gallery": n,
        "n_queries": int(stats["count"]),
        "chance_mrr": chance_mrr(n),
        "mrr": stats["mean_reciprocal_rank"],
        "topk_acc": stats["topk_acc"],
        "rank_mean": stats["mean"],
        "rank_std": stats["std"],
        "final_train_loss": training["train_losses"][-1],
        "final_test_loss": training["test_losses"][-1],
        "epoch_metrics": training.get("epoch_metrics"),
        "dataset": data_params["dataset"],
        "wall_times_s": {
            "data_setup": round(t_data, 2),
            "train_embed_rank_report": round(t_pipeline, 2),
            "inference_time": stats.get("inference_time"),
            "training_time": training.get("training_time"),
        },
    }


def run_generative(preset_name: str, workdir: Path,
                   device: str = "cuda") -> dict:
    """Run the preset's generative CLI inside ``workdir`` (both write
    relative ``results/`` and ``models/`` trees) and return its seeded
    loss trajectories."""
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy

    preset = GENERATIVE_PRESETS[preset_name]
    workdir = workdir.resolve()  # survives the chdir below
    workdir.mkdir(parents=True, exist_ok=True)
    root = make_synthetic_sketchy(workdir / "sketchy", **preset["corpus"])
    argv = preset["argv"] + ["--data_root", str(root), "--device",
                             str(device)]

    t0 = time.perf_counter()
    with contextlib.chdir(workdir):
        if preset["cli"] == "photo2sketch":
            from art_sbir_tpu_torch.cli import photo2sketch

            photo2sketch.main(argv)
        else:
            from art_sbir_tpu_torch.cli import pix2pix

            pix2pix.main(argv)
        runs = sorted((workdir / "results").iterdir())
        training = json.loads((runs[-1] / "training.json").read_text())
    t_cli = time.perf_counter() - t0

    train_losses = training["train_losses"]
    golden = {
        "preset": preset_name,
        **_device_fields(device),
        "config": {k: v for k, v in preset.items() if k != "cli"},
        "train_losses": {k: train_losses[k] for k in preset["loss_keys"]},
        "wall_times_s": {"cli": round(t_cli, 2)},
    }
    if "test_losses" in training:
        golden["test_losses"] = {
            k: training["test_losses"][k] for k in preset["loss_keys"]
            if k in training["test_losses"]}
    return golden


def pin_ci_environment() -> None:
    """What makes a port CPU run repeat bit for bit, the counterpart of
    JAX's pinned backend: one torch intra-op thread (bf16 sums on the CPU
    move with the thread count) and deterministic algorithms. The device
    itself is ``--device cpu``."""
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)


def default_out(preset: str, backend: str, bf16: bool = True) -> Path:
    tag = preset if bf16 else f"{preset}_f32"
    return Path("goldens") / f"torch_{tag}_{backend}.json"


def main(argv=None) -> dict:
    """Record one preset's golden; returns it."""
    p = argparse.ArgumentParser(description="record the port's pipeline "
                                            "goldens")
    p.add_argument("--preset",
                   choices=sorted(PRESETS) + sorted(GENERATIVE_PRESETS),
                   default="scale")
    p.add_argument("--root", type=str, default="data/goldens")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="output JSON (default goldens/torch_<preset>_"
                        "<cpu|cuda>.json); its name starts with torch_")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' records on the CPU")
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   help="the triplet presets train in IEEE float32 (TF32 "
                        "off) instead of cli/train.py's default bf16")
    args = p.parse_args(argv)
    if not args.bf16 and args.preset in GENERATIVE_PRESETS:
        p.error(f"--no-bf16: {args.preset} trains in float32 already")
    out = Path(args.out) if args.out else default_out(
        args.preset, torch.device(args.device).type, args.bf16)
    if not out.name.startswith("torch_"):
        p.error(f"--out {out}: goldens/<preset>_<backend>.json are the JAX "
                "package's; the port's goldens are named torch_*.json")
    if args.preset.endswith("ci") and torch.device(args.device).type == "cpu":
        pin_ci_environment()

    if args.preset in GENERATIVE_PRESETS:
        golden = run_generative(args.preset, Path(args.root) / args.preset,
                                args.device)
        summary = {"preset": args.preset, "backend": golden["backend"],
                   "final": {k: v[-1] for k, v in
                             golden["train_losses"].items()}}
    else:
        golden = run(args.preset, Path(args.root), Path(args.results_root),
                     args.seed, args.device, args.bf16)
        summary = {k: golden[k] for k in
                   ("preset", "backend", "n_gallery", "n_queries", "mrr")}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(golden, indent=2, sort_keys=True))
    print(json.dumps(summary), flush=True)
    print(f"golden written to {out}", flush=True)
    return golden


if __name__ == "__main__":
    main()
