"""Photo2Sketch VAE training CLI (reference `semiSupervised_main.py`).

    python -m art_sbir_tpu_torch.cli.photo2sketch [--setup Sketchy|Quickdraw]
        [--img_format jpg|svg] [--model run.pt] [--bf16]
        [--device cuda|cpu] ...

Counterpart of ``art_sbir_tpu/cli/photo2sketch.py``, with the same flags
and ``--device``. It runs on the card; ``--device cpu`` runs it on the
CPU. Float32 runs IEEE on the card (no TF32).

It trains on VectorizedSketchyV1 (``--img_format jpg``: the photos,
decoded; ``svg``: the sketch itself rasterized from the catalog's cached
points) or QuickdrawV1 (the sketch rasterized from its strokes) with the
reference's hyperparameters. The svg and Quickdraw branches rasterize at
256 px whatever ``--image_size`` says, as JAX does. Every train step draws
``rng.integers(2**31)`` from ``np.random.default_rng(seed)`` and seeds the
step's noise generator with it, and every eval batch takes seed 0, so
each epoch's shuffle is JAX's (the noise itself is torch's, drawn on the
host: the same on the card as on the CPU). Every
``save_rate`` epochs, and after the last, it writes the 4-JSON results
contract (``results/Photo2Sketch_<dataset>_<time>/``, JAX's keys),
``loss_<key>.png`` where matplotlib is installed, the model as
``models/<run>.pt`` (the reference's state-dict keys) and the sample
sheet: greedy decodes of the first test batch's first 4 photos as
``sample_<epoch>_<i>.svg`` and ``.json`` and ``samples_<epoch>.png``
(photo, generated, target).

``--model`` takes a port ``.pt`` or a reference state dict (the same
keys); an orbax directory is refused, naming ``scripts/orbax_to_pt.py``,
which converts it.
``--n_devices N`` (N > 1, -1: every card) trains data parallel with the
results of one device: one rank a device (``parallel/multihost.py``;
``main(argv, mesh=...)`` takes a mesh that may repeat a device), each
building its rows of every batch (a ragged batch whole), the noise drawn
for the global batch, the gradients averaged before the clip, the losses
the global batch's; rank 0 writes the results, the model and the
samples. ``--tp_devices M`` (M > 1) runs a ``(data, model)`` grid of
``--n_devices`` (-1: every card divided by M) times M ranks
(``parallel/tensor.py``): every rank builds the VAE whole from the seed
(and ``--model``), then keeps its channel slices of VGG's convs, the
attention's and the heads' linears and the LSTM's gate matrices (and so
of Adam's moments); rows and noise go by the data index, and the clip
sums the sharded gradients' squares over the model group. The model is
saved in one device's layout (gathered), and rank 0 draws the samples
with the gathered one-device VAE. ``main`` returns the results folder
and the wall time split into catalog parse, batch build, steps and
samples (rank 0's).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.core.checkpoint import ORBAX_DIR, checkpoint_path
from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.core.metrics import LossTracker, Timer
from art_sbir_tpu_torch.core.results import ResultsWriter
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.loader import decode_paths
from art_sbir_tpu_torch.models.port_weights import (load_into,
                                                    load_reference_pth)
from art_sbir_tpu_torch.ops.rasterize import (rasterize_prepared,
                                              rasterize_strokes)
from art_sbir_tpu_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                           normalize)
from art_sbir_tpu_torch.ops.svg import build_svg
from art_sbir_tpu_torch.parallel import multihost
from art_sbir_tpu_torch.parallel.mesh import Mesh, batch_rows, mesh_from_args
from art_sbir_tpu_torch.parallel.tensor import gather_state, model_shard
from art_sbir_tpu_torch.train.vae import LOSS_KEYS, VAEConfig, VAETrainer
from art_sbir_tpu_torch.viz.plots import loss_curves, triplet_grid

NOT_A_MODEL = f"{ORBAX_DIR}; or pass a port .pt or a reference state dict"
SAMPLES = 4  # photos on the sample sheet
SAMPLE_STEPS = 101


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Photo2Sketch")
    p.add_argument("--setup", type=str, default="Sketchy",
                   choices=["Sketchy", "Quickdraw"])
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--max_epoch", type=int, default=1)
    p.add_argument("--dec_rnn_size", type=int, default=512)
    p.add_argument("--z_size", type=int, default=128)
    p.add_argument("--num_mixture", type=int, default=20)
    p.add_argument("--kl_weight_start", type=float, default=0.01)
    p.add_argument("--kl_decay_rate", type=float, default=0.99995)
    p.add_argument("--kl_tolerance", type=float, default=0.2)
    p.add_argument("--kl_weight", type=float, default=1.0)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--decay_rate", type=float, default=0.9999)
    p.add_argument("--min_learning_rate", type=float, default=1e-5)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--save_rate", type=int, default=30)
    p.add_argument("--size", type=float, default=0.1)
    p.add_argument("--img_format", default="jpg", choices=["jpg", "svg"])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--model", type=str, default=None,
                   help="a port .pt or a reference state dict")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 VGG-encoder compute (the decoder, the "
                        "GMM heads and the losses stay float32); off by "
                        "default = the reference's float32")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel ranks (0 or 1 = one device, -1 = "
                        "every card)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel ranks a data index (parameters "
                        "and Adam moments channel-sharded over them); "
                        "combines with --n_devices")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def _imagenet(img01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> ImageNet-normalized (B, 3, H, W)."""
    return normalize(img01, IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2)


def raster_photo(raster: torch.Tensor) -> torch.Tensor:
    """(B, H, W) 0/255 canvases -> the VAE's photo: ``1 - raster / 255``
    over 3 channels, ImageNet-normalized, (B, 3, H, W)."""
    return _imagenet(1.0 - raster[..., None].repeat(1, 1, 1, 3) / 255.0)


def batches(catalog, train: bool, rng: np.random.Generator,
            batch_size: int, image_size: int, device,
            shard: Optional[Tuple[int, int]] = None) -> Iterator[Dict]:
    """The CLI's batches (JAX ``cli/photo2sketch.py:108-130``): the
    catalog's order, shuffled by ``rng`` in train mode; ``sketch_vector``
    (B, T, 5), ``length`` and ``photo`` (B, 3, S, S) on ``device``. The
    photo is the decoded JPEG (``photo_path``), or the sketch rasterized
    from the catalog's cached points (``raster_points``) or from its
    strokes. ``shard`` = (rank, world): the rank's rows only
    (``batch_rows``), with ``rows`` = (offset, total) in the batch for
    the step's noise."""
    order = list(range(len(catalog)))
    if train:
        rng.shuffle(order)
    for s in range(0, len(order), batch_size):
        chunk, rows = order[s: s + batch_size], None
        if shard is not None:
            sl = batch_rows(len(chunk), *shard)
            chunk, rows = chunk[sl], (sl.start, len(chunk))
        items = [catalog.item(i) for i in chunk]
        vec = torch.from_numpy(np.stack([it["sketch_vector"]
                                         for it in items])).to(device)
        if "photo_path" in items[0]:
            u8 = decode_paths([it["photo_path"] for it in items], image_size)
            photo = _imagenet(torch.from_numpy(u8).to(device).float() / 255.0)
        elif "raster_points" in items[0]:
            pts, segs = (torch.from_numpy(np.stack([it[k] for it in items]))
                         .to(device) for k in ("raster_points", "raster_segs"))
            photo = raster_photo(rasterize_prepared(pts, segs))
        else:
            photo = raster_photo(rasterize_strokes(vec))
        yield {"photo": photo, "sketch_vector": vec,
               "length": torch.tensor([it["length"] for it in items]),
               "rows": rows}


def load_weights(trainer: VAETrainer, src: str) -> None:
    """``--model`` into the trainer's model."""
    if Path(src).is_dir():
        raise SystemExit(f"--model {src}: {NOT_A_MODEL}")
    load_into(trainer.model, load_reference_pth(src),
              f"Photo2Sketch from {src}")


def write_samples(trainer: VAETrainer, batch: Dict, folder: Path,
                  epoch: int) -> None:
    """The sample sheet of ``batch``'s first photos (JAX
    ``cli/photo2sketch.py:178-206``)."""
    strokes, _ = trainer.generate(batch["photo"][:SAMPLES], SAMPLE_STEPS)
    gen = rasterize_strokes(strokes).cpu().numpy()
    tgt = rasterize_strokes(batch["sketch_vector"][:SAMPLES]).cpu().numpy()
    photos = batch["photo"][:SAMPLES].permute(0, 2, 3, 1).cpu().numpy()
    mean, std = np.asarray(IMAGENET_MEAN), np.asarray(IMAGENET_STD)
    strokes = strokes.cpu().numpy()
    trips = []
    for i in range(strokes.shape[0]):
        photo01 = np.clip(photos[i] * std + mean, 0, 1)
        trips.append((photo01, 255 - gen[i], 255 - tgt[i]))
        build_svg(strokes[i], (256, 256), folder / f"sample_{epoch}_{i}.svg")
        (folder / f"sample_{epoch}_{i}.json").write_text(json.dumps(
            {"shape": [256, 256], "image": strokes[i].tolist()}))
    triplet_grid(trips, folder / f"samples_{epoch}.png",
                 titles=("photo", "generated", "target"))


def main(argv=None, mesh: Optional[Mesh] = None) -> Dict:
    """Returns ``{"folder": results folder, "model": models/<run>.pt,
    "wall_s", "catalog_s", "batch_s", "step_s", "samples_s"}`` (seconds
    from the catalog parse on; ``step_s`` holds the eval batches' losses
    too, and waits for the card once a pass over a catalog). ``mesh``:
    the ranks' devices (a 2-D mesh for tensor parallelism), in place of
    ``--n_devices`` and ``--tp_devices``."""
    args = build_parser().parse_args(argv)
    if mesh is None:
        mesh = mesh_from_args(args.n_devices, args.tp_devices, args.device)
    if mesh is not None and mesh.size > 1:
        return multihost.spawn(run, mesh.devices, args,
                               n_model=mesh.n_model)
    return run(resolve_device(args.device if mesh is None
                              else mesh.devices[0]), args)


def run(device: torch.device, args: argparse.Namespace) -> Optional[Dict]:
    """:func:`main` on ``device``, as one rank of the group where this
    process is in one (None on a rank other than 0)."""
    lead = multihost.rank() == 0
    d_rank, n_data = multihost.data_rank(), multihost.data_size()
    shard = (d_rank, n_data) if n_data > 1 else None
    ieee_f32()
    cfg = VAEConfig(
        z_size=args.z_size, dec_rnn_size=args.dec_rnn_size,
        num_mixture=args.num_mixture, learning_rate=args.learning_rate,
        min_learning_rate=args.min_learning_rate, decay_rate=args.decay_rate,
        kl_weight=args.kl_weight, kl_weight_start=args.kl_weight_start,
        kl_decay_rate=args.kl_decay_rate, kl_tolerance=args.kl_tolerance,
        grad_clip=args.grad_clip, image_size=args.image_size,
        bf16_encoder=args.bf16)
    trainer = VAETrainer(cfg, args.seed, device)
    if args.model:
        load_weights(trainer, args.model)
    multihost.broadcast_state(trainer.model)
    tp = model_shard()
    trainer.tensor_parallel(tp)

    t0 = time.perf_counter()
    dataset = "VectorizedSketchyV1" if args.setup == "Sketchy" else "QuickdrawV1"
    train_cat, test_cat = get_datasets(
        dataset=dataset, size=args.size, img_format=args.img_format,
        max_erase_count=1, root=args.data_root)
    split = {"catalog_s": time.perf_counter() - t0, "batch_s": 0.0,
             "step_s": 0.0, "samples_s": 0.0}

    def timed(it: Iterator[Dict]) -> Iterator[Dict]:
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            split["batch_s"] += time.perf_counter() - t
            if batch is None:
                return
            yield batch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(args.seed)
    train_tracker = LossTracker(list(LOSS_KEYS))
    test_tracker = LossTracker(list(LOSS_KEYS))
    timer = Timer()
    folder: Optional[Path] = None
    model_path: Optional[Path] = None
    for epoch in range(args.max_epoch):
        for tracker, catalog, train in ((train_tracker, train_cat, True),
                                        (test_tracker, test_cat, False)):
            tracker.reset_sums()
            n = 0
            for batch in timed(batches(catalog, train, rng, args.batchsize,
                                       args.image_size, device, shard)):
                t = time.perf_counter()
                if train:
                    losses = trainer.train_step(
                        batch, int(rng.integers(2**31)), batch["rows"])
                else:
                    losses = trainer.eval_step(batch, 0, batch["rows"])
                tracker.add(losses, args.batchsize)  # no wait a step
                split["step_s"] += time.perf_counter() - t
                n += 1
            t = time.perf_counter()
            tracker.append(dict(tracker.sums), max(n, 1))
            sync()
            split["step_s"] += time.perf_counter() - t
            if train and lead:
                print(f"Epoch:{epoch} ** Train ** "
                      f"sup_p2s_loss:{tracker.series['reconstruction_loss'][-1]}"
                      f" ** kl:{tracker.series['kl_loss'][-1]} "
                      f"** total:{tracker.series['total_loss'][-1]}",
                      flush=True)

        if not ((epoch + 1) % args.save_rate == 0
                or epoch + 1 == args.max_epoch):
            continue
        t = time.perf_counter()
        state = gather_state(trainer.model)  # every rank under TP
        if lead:
            one = trainer
            if tp is not None:  # the samples from one device's VAE
                one = VAETrainer(cfg, args.seed, device)
                one.model.load_state_dict(state)
            writer = ResultsWriter("Photo2Sketch",
                                   train_cat.state_dict["dataset"])
            folder = writer.path
            training_dict = {"train_losses": dict(train_tracker.series),
                             "test_losses": dict(test_tracker.series),
                             "training_time": timer.elapsed()}
            params = {k: v for k, v in vars(args).items() if k != "device"}
            writer.write_all(train_cat.state_dict, training_dict, params, {})
            model_path = checkpoint_path("models", writer.run_name)
            model_path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({k: v.cpu() for k, v in state.items()}, model_path)
            if importlib.util.find_spec("matplotlib") is not None:
                for k in LOSS_KEYS:
                    loss_curves(train_tracker.series[k],
                                test_tracker.series[k],
                                folder / f"loss_{k}.png", title=k)
            for batch in batches(test_cat, False, rng, args.batchsize,
                                 args.image_size, device):
                write_samples(one, batch, folder, epoch + 1)
                break
            split["samples_s"] += time.perf_counter() - t

    if not lead:
        return None
    wall = time.perf_counter() - t0
    print(f"Training done in {timer.elapsed():.1f}s", flush=True)
    return {"folder": folder, "model": model_path, "wall_s": wall, **split}


if __name__ == "__main__":
    main()
