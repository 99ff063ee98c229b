"""pix2pix photo->sketch CLI (reference `pix2pix_main.py`).

    python -m art_sbir_tpu_torch.cli.pix2pix [--mode generate|train]
        [--netG resnet_9blocks|unet_256] [--model <dir>|G.pth|run.pt]
        [--bf16] [--device cuda|cpu] ...

Counterpart of ``art_sbir_tpu/cli/pix2pix.py``, with the same flags and
``--device``. It runs on the card; ``--device cpu`` runs it on the CPU.
Float32 runs IEEE on the card (no TF32).

* ``--mode generate`` writes ``G(photo)`` for the test catalog, then the
  train catalog, as ``<out_dir>/<stem>.png`` (``data/kaggle/photo_sketch``
  by default, `pix2pix_main.py:95-119`), each pixel ``uint8((clip(x, -1,
  1) + 1) / 2 * 255)``, truncating (:func:`to_uint8`). Decode, forward and
  PNG write overlap as in ``cli/drawings.py``; the returned dict gives
  the wall time and its split.
* ``--mode train``: the first epoch steps D only (the reference's warm-up,
  `pix2pix_main.py:29-31`), then full G+D steps; the losses of each epoch,
  the 4-JSON results contract (``results/Pix2PixModel_<dataset>_<time>/``,
  the JAX package's keys), ``loss_<key>.png`` where matplotlib is
  installed, a sample sheet of (photo, fake, real) triplets from the test
  set (``samples.png``) and both nets in ``models/<run>.pt``. Every step
  draws ``rng.integers(2**31)`` from ``np.random.default_rng(seed)``, as
  the JAX CLI does, and seeds G's dropout with it, so each epoch's
  shuffle is JAX's. The batches are not flipped (ROADMAP.md §3).
* ``--checkpoint_dir``: ``<epoch>.pt`` checkpoints of both nets, both Adam
  states and the numpy generator's state; ``--continue_train`` resumes
  from the latest (or ``--load_iter``) and so trains on as the
  uninterrupted run would have.
* ``--model``: a reference directory holding ``latest_net_G.pth`` and,
  optionally, ``latest_net_D.pth`` (a D that does not load keeps its
  fresh init, as the reference skips it), a G ``.pth`` alone, or a port
  ``.pt`` written by train mode. An orbax directory is refused, naming
  ``scripts/orbax_to_pt.py``, which converts it. Without it both nets
  take JAX's own fresh init for ``--seed`` (``train/gan.py::Pix2Pix``,
  drawn without JAX by ``models/flax_families.py``).
* ``--n_devices N`` (train mode; N > 1, -1: every card) trains data
  parallel with the results of one device: one rank a device
  (``parallel/multihost.py``; ``main(argv, mesh=...)`` takes a mesh that
  may repeat a device), each decoding its rows of every batch (a ragged
  batch whole), both nets' BatchNorm over the global batch, G's dropout
  masks drawn for the global batch, both gradient sets averaged. Every
  rank resumes from the same checkpoint; rank 0 writes the checkpoints,
  the results, the sample sheet and ``models/<run>.pt``.
* ``--tp_devices M`` (M > 1; train and generate mode) runs a ``(data,
  model)`` grid of ``--n_devices`` (-1: every card divided by M) times M
  ranks (``parallel/tensor.py``): every rank builds both nets whole from
  the seed (and ``--model``), then keeps its channel slices of the
  parameters, BatchNorm statistics and Adam states; each conv computes
  its slice of the output channels and the slices are gathered. Rows and
  dropout masks go by the data index. Checkpoints and ``models/<run>.pt``
  are in one device's layout (gathered; a resume cuts them to the
  slices); rank 0 draws the sample sheet with the gathered one-device
  nets. Generate mode runs on one data index (every rank computes each
  batch column-parallel; rank 0 writes the PNGs).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from art_sbir_tpu_torch.cli.drawings import overlapped
from art_sbir_tpu_torch.core.checkpoint import (ORBAX_DIR, CheckpointManager,
                                                checkpoint_path,
                                                load_state_dict)
from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.core.metrics import LossTracker, Timer
from art_sbir_tpu_torch.core.results import ResultsWriter
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.loader import decode_paths
from art_sbir_tpu_torch.models.port_weights import (load_into,
                                                    load_pix2pix_reference)
from art_sbir_tpu_torch.parallel import multihost
from art_sbir_tpu_torch.parallel.mesh import Mesh, batch_rows, mesh_from_args
from art_sbir_tpu_torch.parallel.tensor import model_shard
from art_sbir_tpu_torch.train.gan import LOSS_KEYS, Pix2Pix, Pix2PixConfig
from art_sbir_tpu_torch.viz.plots import triplet_grid, visualize

NOT_A_MODEL = (f"{ORBAX_DIR}; or pass a directory holding "
               "latest_net_G.pth, a G .pth or a port .pt")


def to_uint8(img_signed: torch.Tensor) -> torch.Tensor:
    """[-1, 1] tanh output -> uint8, truncating (reference
    `utils.py:105-111`), in the JAX package's float32 operations."""
    return ((img_signed.clamp(-1, 1) + 1.0) / 2.0 * 255.0).to(torch.uint8)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pix2pix photo->sketch")
    p.add_argument("--mode", choices=["train", "generate"], default="generate")
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("-b", "--batch_size", type=int, default=6)
    p.add_argument("-l", "--lr", type=float, default=1e-5)
    p.add_argument("--lambda_L1", type=float, default=10.0)
    p.add_argument("--netG", default="resnet_9blocks",
                   choices=["resnet_9blocks", "unet_256"])
    p.add_argument("--netD", default="basic",
                   choices=["basic", "n_layers", "pixel"])
    p.add_argument("--norm", default="batch",
                   choices=["batch", "instance", "none"])
    p.add_argument("--gan_mode", default="vanilla",
                   choices=["vanilla", "lsgan", "wgangp"])
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 network compute (float32 master weights, "
                        "optimizer state, BN running stats and losses); "
                        "off by default = the reference's float32")
    p.add_argument("--dataset", default="SketchyPix2Pix",
                   choices=["SketchyPix2Pix", "KaggleDatasetImgOnlyV1"])
    p.add_argument("--img_type", default=None,
                   help="image folder (default: 'images' for Kaggle, "
                        "'photos' for Sketchy; reference pix2pix_main.py:188)")
    p.add_argument("-s", "--dsize", type=float, default=1.0)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--out_dir", type=str, default="data/kaggle/photo_sketch")
    p.add_argument("--model", type=str, default=None,
                   help="a reference directory (latest_net_G.pth, "
                        "latest_net_D.pth), a G .pth or a port .pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="epoch-tagged resumable checkpoints (<epoch>.pt)")
    p.add_argument("--checkpoint_every", type=int, default=1)
    p.add_argument("--continue_train", action="store_true",
                   help="resume from checkpoint_dir")
    p.add_argument("--load_iter", type=int, default=0,
                   help="epoch to resume from (0 = latest)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel ranks in train mode (0 or 1 = one "
                        "device, -1 = every card)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel ranks a data index (both nets' "
                        "parameters, Adam states and BatchNorm statistics "
                        "channel-sharded over them); combines with "
                        "--n_devices")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def load_weights(model: Pix2Pix, src: str) -> None:
    """``--model`` into ``model``'s nets (see the module docstring)."""
    if src.endswith(".pt"):
        sd = load_state_dict(src)
        load_into(model.net_g, sd["G"], f"pix2pix G from {src}")
        load_into(model.net_d, sd["D"], f"pix2pix D from {src}")
        return
    if Path(src).is_dir() and not (Path(src) / "latest_net_G.pth").exists():
        raise SystemExit(f"--model {src}: {NOT_A_MODEL}")
    g_sd, d_sd = load_pix2pix_reference(src)
    load_into(model.net_g, g_sd, f"pix2pix G from {src}")
    if d_sd is not None:
        try:
            load_into(model.net_d, d_sd, f"pix2pix D from {src}")
        except (KeyError, RuntimeError) as e:  # reference utils.py:151
            print(f"netD not loaded ({e}); keeping its fresh init",
                  flush=True)


def _paths(catalog) -> List[Path]:
    items = (catalog.item(i) for i in range(len(catalog)))
    return [Path(it.get("A", it.get("image"))) for it in items]


def _batches(catalog, size: int, batch_size: int,
             rng: Optional[np.random.Generator],
             shard: Optional[Tuple[int, int]] = None
             ) -> Iterator[Tuple[Dict, Optional[Tuple[int, int]]]]:
    """(batch, rows): uint8 NHWC batches ``A`` (and ``B``, one channel,
    where the catalog pairs), shuffled by ``rng`` (JAX
    ``cli/pix2pix.py:114-136``). ``shard`` = (rank, world): the rank's
    rows only (``batch_rows``), with ``rows`` = (offset, total) for the
    step's random draws."""
    order = list(range(len(catalog)))
    if rng is not None:
        rng.shuffle(order)
    for s in range(0, len(order), batch_size):
        chunk, rows = order[s: s + batch_size], None
        if shard is not None:
            sl = batch_rows(len(chunk), *shard)
            chunk, rows = chunk[sl], (sl.start, len(chunk))
        items = [catalog.item(i) for i in chunk]
        batch = {"A": decode_paths([it.get("A", it.get("image"))
                                    for it in items], size)}
        if "B" in items[0]:
            batch["B"] = decode_paths([it["B"] for it in items], size,
                                      grayscale=True)
        yield batch, rows


def _to_device(u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [0, 1] on ``device``."""
    x = torch.from_numpy(u8).to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).float() / 255.0


def generate(model: Pix2Pix, catalogs, args, device: torch.device
             ) -> Dict[str, float]:
    """G of every photo of ``catalogs``, written as PNGs; the wall time and
    its split."""
    from PIL import Image

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    chunks = []
    for catalog in catalogs:
        if catalog is not None:
            paths = _paths(catalog)
            chunks += [paths[s: s + args.batch_size]
                       for s in range(0, len(paths), args.batch_size)]

    lead = multihost.rank() == 0

    def write(imgs: np.ndarray, chunk) -> None:
        if not lead:  # every rank computes the batch; rank 0 writes it
            return
        for img, path in zip(imgs, chunk):
            Image.fromarray(img, mode="L").save(out_dir / f"{path.stem}.png")

    def forward(u8: torch.Tensor) -> torch.Tensor:
        x = u8.permute(0, 3, 1, 2).float() / 255.0
        return to_uint8(model.generate(x)[:, 0])

    stats = {"images": sum(map(len, chunks)), **overlapped(
        chunks, lambda chunk: decode_paths(chunk, args.image_size), forward,
        write, device)}
    print(f"Generated sketches written to {out_dir} in {stats['wall_s']:.3f}"
          f" s (decode {stats['decode_s']:.3f} s on the prefetch thread, "
          f"waited {stats['wait_s']:.3f} s; forward {stats['forward_s']:.3f}"
          f" s; write {stats['write_s']:.3f} s)", flush=True)
    return stats


def train(model: Pix2Pix, train_cat, test_cat, args, cfg: Pix2PixConfig,
          device: torch.device) -> Path:
    """The epochs, the results folder, the sample sheet and the export;
    returns the results folder (None on a rank other than 0)."""
    lead = multihost.rank() == 0
    d_rank, n_data = multihost.data_rank(), multihost.data_size()
    rng = np.random.default_rng(args.seed)
    tracker = LossTracker(list(LOSS_KEYS))
    timer = Timer()
    mgr = None
    start_epoch = 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        if args.continue_train:
            step = args.load_iter or None  # None = the latest
            state = mgr.restore(step)
            model.load_state_dict(state)
            rng.bit_generator.state = state["numpy_rng"]
            start_epoch = int(step or mgr.latest_step())
            if lead:
                print(f"Resumed pix2pix from epoch {start_epoch}",
                      flush=True)
            multihost.broadcast_state(model.net_g, model.net_d, model.opt_g,
                                      model.opt_d)

    shard = (d_rank, n_data) if n_data > 1 else None
    for epoch in range(start_epoch, args.epochs):
        tracker.reset_sums()
        n = 0
        for batch, rows in _batches(train_cat, args.image_size,
                                    args.batch_size, rng, shard):
            losses = model.train_step(
                {k: _to_device(v, device) for k, v in batch.items()},
                int(rng.integers(2**31)),
                decoder_only=(epoch == 0),  # the reference's warm-up epoch
                rows=rows)
            tracker.add(losses)  # device scalars: no wait a step
            n += 1
        tracker.append(dict(tracker.sums), max(n, 1))
        if lead:
            print(f"Epoch {epoch + 1}: " + ", ".join(
                f"{k}={tracker.series[k][-1]:.4f}" for k in LOSS_KEYS),
                flush=True)
        if mgr is not None and (epoch + 1) % args.checkpoint_every == 0:
            state = model.state_dict()  # gathered under TP: every rank
            if lead:
                mgr.save(epoch + 1, {**state,
                                     "numpy_rng": rng.bit_generator.state})
    if model.tp is not None:  # the export and samples: one device's nets
        state = model.state_dict()  # every rank gathers its slices
        if lead:
            model = Pix2Pix(cfg, args.seed, device)
            model.load_state_dict(state)
    if not lead:
        return None

    writer = ResultsWriter("Pix2PixModel", train_cat.state_dict["dataset"])
    training_dict = {"train_losses": dict(tracker.series),
                     "training_time": timer.elapsed()}
    writer.write_all(train_cat.state_dict, training_dict,
                     {"lambda_L1": cfg.lambda_l1, "lr": cfg.lr,
                      "netG": cfg.net_g, "netD": cfg.net_d,
                      "gan_mode": cfg.gan_mode, "norm": cfg.norm,
                      "epochs": args.epochs, "batch_size": args.batch_size},
                     {})
    visualize(writer.path, training_dict, {})
    path = checkpoint_path("models", writer.run_name)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"G": {k: v.cpu() for k, v in model.net_g.state_dict().items()},
                "D": {k: v.cpu() for k, v in model.net_d.state_dict().items()}},
               path)
    # the sample sheet: (photo, fake, real) triplets from the test set
    for batch, _ in _batches(test_cat, args.image_size, args.batch_size,
                             None):
        if "B" not in batch:
            break
        fake = to_uint8(model.generate(_to_device(batch["A"], device)))
        fake = fake.permute(0, 2, 3, 1).cpu().numpy()
        trips = [(batch["A"][i], fake[i], batch["B"][i])
                 for i in range(min(4, fake.shape[0]))]
        triplet_grid(trips, writer.path / "samples.png",
                     titles=("photo", "fake sketch", "real sketch"))
        break
    print(f"Model saved as {path}; data saved in {writer.path}", flush=True)
    return writer.path


def main(argv=None, mesh: Optional[Mesh] = None):
    """Generate mode returns the count, the wall time and its split
    (seconds); train mode returns the results folder. ``mesh``: the
    ranks' devices (a 2-D mesh for tensor parallelism), in place of
    ``--n_devices`` and ``--tp_devices``."""
    args = build_parser().parse_args(argv)
    if mesh is None:
        mesh = mesh_from_args(args.n_devices, args.tp_devices, args.device)
    if mesh is not None and mesh.size > 1:
        if args.mode != "train" and mesh.n_data > 1:
            raise SystemExit(f"--n_devices {args.n_devices}: data "
                             "parallelism is for --mode train; generate "
                             "runs on one data index")
        return multihost.spawn(run, mesh.devices, args,
                               n_model=mesh.n_model)
    return run(resolve_device(args.device if mesh is None
                              else mesh.devices[0]), args)


def run(device: torch.device, args: argparse.Namespace):
    """:func:`main` on ``device``, as one rank of the group where this
    process is in one."""
    ieee_f32()
    cfg = Pix2PixConfig(
        net_g=args.netG, net_d=args.netD, norm=args.norm,
        gan_mode=args.gan_mode, lambda_l1=args.lambda_L1, lr=args.lr,
        image_size=args.image_size, ngf=args.ngf, ndf=args.ndf,
        bf16=args.bf16)
    model = Pix2Pix(cfg, args.seed, device)
    if args.model:
        load_weights(model, args.model)
    multihost.broadcast_state(model.net_g, model.net_d)
    model.tensor_parallel(model_shard())
    img_type = args.img_type or ("images" if "Kaggle" in args.dataset
                                 else "photos")
    train_cat, test_cat = get_datasets(
        dataset=args.dataset, size=args.dsize, root=args.data_root,
        img_type=img_type)
    if args.mode == "train":
        return train(model, train_cat, test_cat, args, cfg, device)
    return generate(model, (test_cat, train_cat), args, device)


if __name__ == "__main__":
    main()
