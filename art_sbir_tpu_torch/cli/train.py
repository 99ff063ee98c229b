"""Triplet-training CLI, the flag surface of reference `train.py:105-124`.

    python -m art_sbir_tpu_torch.cli.train -e 1 -b 32 -d SketchyV2
        [--model_type ModifiedResNet_with_classification] [--inference]
        [--device cuda|cpu] ...

Counterpart of ``art_sbir_tpu/cli/train.py``. End to end: catalogs ->
host loader (uint8, one prefetch thread) -> device finishing (normalize,
augment) -> the triplet step (three forwards, backward, Adam) -> retrieval
evaluation -> ``models/<run>.pt`` (and ``models/<run>_bn_sketch.pt`` under
``--bn_recalibrate per_modality``), the 4-JSON results contract and the
plots. It runs on the card; ``--device cpu`` runs it on the CPU.

Data parallel (``parallel/multihost.py``), with the results of one device:

* ``--n_devices N`` (N > 1; -1: every card) starts N ranks, rank ``i`` on
  card ``i`` (NCCL), or N ranks on the CPU under ``--device cpu``
  (gloo); with fewer cards than asked it exits. ``main(argv, mesh=...)``
  takes a mesh instead, which may repeat a device (two ranks on one
  card run over gloo).
* ``--multihost`` joins the group torchrun's environment describes, one
  rank a process on card ``LOCAL_RANK``; without that environment it
  trains on one process.
* Each rank decodes its rows of every batch (``TripletLoader(shard=)``),
  BatchNorm takes the global batch's statistics, augmentation draws the
  global batch's parameters, the gradients are averaged before the Adam
  step and the logged losses are the global batch's. Rank 0 alone runs
  ``--eval_every_epoch`` (the others wait at a barrier), writes the
  checkpoints, and after training runs ``--bn_recalibrate`` and
  ``--inference`` (over a gallery mesh of the ranks' distinct cards) and
  writes the results and ``models/<run>.pt``; the others leave.

Tensor parallel (``parallel/tensor.py``), with the results of one device:

* ``--tp_devices M`` (M > 1) starts a ``(data, model)`` grid of
  ``--n_devices`` (-1: every card divided by M) times M ranks, rank ``d *
  M + m`` on card ``d * M + m`` (on the CPU under ``--device cpu``); it
  exits with fewer cards, and with ``--multihost`` (JAX's rule: single
  host). ``main(argv, mesh=...)`` takes ``tensor.mesh_2d``'s mesh, which
  may repeat a device.
* Every rank builds the whole encoder from the seed (and ``--model``),
  then keeps its channel slices of the parameters, BatchNorm statistics
  and (so) Adam's moments; each conv and linear computes its slice of
  the output channels and the slices are gathered. Rows, augmentation
  and BatchNorm's statistics go by the data index; the ranks of a model
  group hold the same rows.
* Checkpoints (``--checkpoint_dir``, ``--resume``) and ``models/<run>.pt``
  are in one device's layout, gathered from the slices; a resume cuts
  them to the rank's slices, so a run resumes across layouts. Rank 0 runs
  ``--eval_every_epoch``, ``--bn_recalibrate`` and ``--inference`` on the
  gathered one-device encoder, over a gallery mesh of the data axis's
  cards. ``training_params.json`` records ``n_devices`` (every rank) and
  ``tp_devices``.
"""

from __future__ import annotations

import argparse
import copy
import os
from pathlib import Path
from typing import Optional, Sequence

import torch

from art_sbir_tpu_torch.core.checkpoint import (CheckpointManager,
                                                checkpoint_path,
                                                load_state_dict,
                                                refuse_orbax_run,
                                                save_state_dict)
from art_sbir_tpu_torch.core.device import ieee_f32, resolve_device
from art_sbir_tpu_torch.core.metrics import maybe_profile
from art_sbir_tpu_torch.core.results import ResultsWriter
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.loader import TripletLoader
from art_sbir_tpu_torch.models.resnet import create_encoder
from art_sbir_tpu_torch.parallel import multihost
from art_sbir_tpu_torch.parallel.mesh import Mesh, MeshSpec, mesh_from_args
from art_sbir_tpu_torch.parallel.tensor import (gather_state, model_shard,
                                                tensor_parallel)
from art_sbir_tpu_torch.retrieval.engine import run_inference
from art_sbir_tpu_torch.train.bn import recalibrate_from_catalog, with_stats
from art_sbir_tpu_torch.train.losses import TripletLossConfig
from art_sbir_tpu_torch.train.prepare import (finish_gallery_batch,
                                              finish_triplet_batch)
from art_sbir_tpu_torch.train.triplet import TripletTrainer, create_train_state
from art_sbir_tpu_torch.viz.plots import visualize



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Starts training a model")
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("-b", "--batch_size", type=int, default=32)
    p.add_argument("-l", "--learning_rate", type=float, default=1e-5)
    p.add_argument("-m", "--model", type=str, default=None,
                   help="state dict to warm-start from: a port .pt or a "
                        "reference .pth in the ModifiedResNet layout")
    p.add_argument("--model_type", type=str,
                   default="ModifiedResNet_with_classification",
                   choices=["ModifiedResNet",
                            "ModifiedResNet_with_classification"])
    p.add_argument("-d", "--dataset", type=str, default="SketchyV1",
                   choices=["SketchyV1", "SketchyV2", "KaggleV1", "KaggleV2",
                            "AugmentedKaggleV1", "AugmentedKaggleV2",
                            "MixedDatasetV1", "MixedDatasetV2",
                            "MixedDatasetV3", "MixedDatasetV4",
                            "CategorizedMixedDatasetV2"])
    p.add_argument("-s", "--dsize", type=float, default=1.0)
    p.add_argument("--inference", action="store_true")
    p.add_argument("--feature_folder", default=None)
    p.add_argument("--no_training", action="store_true")
    p.add_argument("-w", "--weight_decay", type=float, default=2e-3)
    p.add_argument("--img_type", type=str, default="photos",
                   choices=["photos", "anime_drawings", "contour_drawings",
                            "images", "artworks"])
    p.add_argument("--sketch_type", default="sketches_png",
                   choices=["sketches_png", "contour_drawings",
                            "opensketch_drawings", "photo_sketch",
                            "adain_sketches", "combination",
                            "dilated_opensketch_drawings"])
    p.add_argument("--sketch_format", default="png", choices=["png", "jpg"])
    p.add_argument("--loss_type", default="euclidean",
                   choices=["euclidean", "cosine"])
    p.add_argument("--loss_margin", type=float, default=0.2)
    p.add_argument("--resize_mode", default="auto",
                   choices=["auto", "square", "shortest_crop"],
                   help="host decode geometry; 'auto' = the dataset family's "
                        "(shortest-side resize + center crop for "
                        "Sketchy/Kaggle, square for Augmented/Mixed)")
    p.add_argument("--split_ratio", type=float, default=0.1,
                   help="test fraction of the seeded train/test split "
                        "(reference data_preparation.py:50)")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=125)
    p.add_argument("--num_classes2", type=int, default=0)
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--width", type=int, default=64,
                   help="encoder stem width (64 = the reference CLIP RN50; "
                        "smaller values give CPU-sized test encoders)")
    p.add_argument("--layers", type=int, nargs=4, default=[3, 4, 6, 3],
                   help="bottleneck blocks per stage (3 4 6 3 = RN50)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="bf16 compute with float32 parameters (default); "
                        "--no-bf16 computes in IEEE float32 (TF32 off)")
    p.add_argument("--bn_recalibrate", default="off",
                   choices=["off", "mixed", "per_modality"],
                   help="BatchNorm recalibration over a train-split "
                        "sketch+photo sweep after training: 'mixed' "
                        "replaces the running stats with balanced "
                        "population stats; 'per_modality' embeds queries "
                        "with sketch and the gallery with photo stats")
    p.add_argument("--bn_sweep_batches", type=int, default=64,
                   help="max recalibration batches per modality")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="epoch-tagged resumable checkpoints (<epoch>.pt)")
    p.add_argument("--checkpoint_every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in checkpoint_dir")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of training")
    p.add_argument("--eval_every_epoch", action="store_true",
                   help="run the retrieval evaluation after every epoch and "
                        "record MRR/recall@K per epoch in training.json "
                        "(epoch_metrics)")
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel ranks (1 = one device, -1 = every "
                        "card): one process a device, BatchNorm over the "
                        "global batch, gradients averaged")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel ranks a data index (parameters, "
                        "Adam moments and BatchNorm statistics "
                        "channel-sharded over them); combines with "
                        "--n_devices; single host")
    p.add_argument("--multihost", action="store_true",
                   help="join the group torchrun's environment describes "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT), one rank a process")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' trains on the CPU")
    return p


def load_warm_start(model: torch.nn.Module, path: str) -> None:
    """Load a state dict in the reference layout with ``strict=False``
    semantics (missing keys keep their init, reference
    `utils.py:167,172`); a classifier head whose size differs from the
    model's is dropped for re-initialization (`utils.py:177-197`). A
    directory (a run the JAX package saved with orbax) loads the ``.pt``
    beside it, ``<path>.pt``, which ``scripts/orbax_to_pt.py`` writes; with
    none there it raises ``SystemExit`` naming the tool."""
    if Path(path).is_dir():
        run = Path(path)
        refuse_orbax_run(run.parent, run.name)
        path = checkpoint_path(run.parent, run.name)
    sd = load_state_dict(path)
    own = model.state_dict()
    for name in ("classifier", "classifier2"):
        w = f"{name}.weight"
        if w in sd and (w not in own or sd[w].shape != own[w].shape):
            sd = {k: v for k, v in sd.items()
                  if not k.startswith(name + ".")}
    model.load_state_dict(sd, strict=False)


def main(argv=None, mesh: Optional[Mesh] = None) -> Path:
    """Train; returns the results folder. ``mesh``: the ranks' devices (a
    2-D mesh for tensor parallelism), in place of ``--n_devices`` and
    ``--tp_devices``."""
    args = build_parser().parse_args(argv)
    if mesh is None:  # exits with fewer cards, or for TP with --multihost
        mesh = mesh_from_args(args.n_devices, args.tp_devices, args.device,
                              args.multihost)
    if args.multihost:
        if mesh is not None:
            raise SystemExit("--multihost runs one rank a process; drop "
                             "--n_devices")
        device = multihost.initialize(args.device)
        if device is not None:
            try:
                local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
                return train(device, args, [torch.device(device.type, i)
                                            for i in range(local)]
                             if device.type == "cuda" else [device])
            finally:
                multihost.leave()
    if mesh is not None and mesh.size > 1:
        args.tp_devices = mesh.n_model
        return multihost.spawn(train, mesh.devices, args,
                               mesh.data_devices(), n_model=mesh.n_model)
    return train(resolve_device(args.device if mesh is None
                                else mesh.devices[0]), args)


def _gallery_mesh(devices: Sequence[torch.device]) -> Optional[Mesh]:
    """Rank 0's gallery mesh for the evaluation: the ranks' distinct
    cards (None for one device)."""
    devices = list(dict.fromkeys(torch.device(d) for d in devices))
    return MeshSpec(len(devices)).build(devices) if len(devices) > 1 else None


def train(device: torch.device, args: argparse.Namespace,
          devices: Sequence[torch.device] = ()) -> Optional[Path]:
    """The run on ``device``, as one rank of the group where this process
    is in one; returns the results folder on rank 0 (None elsewhere).
    ``devices``: the data axis's distinct devices on this host, which rank
    0's evaluation shards the gallery over."""
    rank, world = multihost.rank(), multihost.world_size()
    d_rank, n_data = multihost.data_rank(), multihost.data_size()
    shard = model_shard()
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    if not args.bf16:
        ieee_f32()

    sketch_type = args.sketch_type
    if sketch_type == "combination":  # reference train.py:126
        sketch_type = ["contour_drawings", "opensketch_drawings",
                       "dilated_opensketch_drawings"]
    img_format = "png" if "drawings" in args.img_type else "jpg"

    with_classification = "with_classification" in args.model_type
    num_classes2 = args.num_classes2
    if with_classification and "Kaggle" in args.dataset and num_classes2 == 0:
        num_classes2 = 32  # styles+genres heads (reference utils.py:180)

    def build():
        return create_encoder(
            with_classification=with_classification,
            num_classes=args.num_classes, num_classes2=num_classes2,
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
            device=device, seed=args.seed, input_resolution=args.image_size,
            width=args.width, layers=tuple(args.layers))

    model = build()
    model_name = type(model).__name__

    train_cat, test_cat = get_datasets(
        dataset=args.dataset, size=args.dsize, sketch_type=sketch_type,
        sketch_format=args.sketch_format, img_type=args.img_type,
        img_format=img_format, root=args.data_root,
        split_ratio=args.split_ratio)

    with_cls_loss = (with_classification
                     and "V2" in train_cat.state_dict["dataset"])
    loss_cfg = TripletLossConfig.for_dataset(
        train_cat.state_dict["dataset"], args.loss_type, with_cls_loss,
        margin=args.loss_margin)

    if args.model:
        load_warm_start(model, args.model)
        say(f"Model {args.model} loaded", flush=True)
    multihost.broadcast_state(model)
    tensor_parallel(model, shard)
    state = create_train_state(model, args.learning_rate, args.weight_decay)

    def one_device(m):
        """``m`` in one device's layout on rank 0 (every rank of a model
        group gathers its slices; None elsewhere), eval mode."""
        if shard is None:
            return m.eval()
        sd = gather_state(m)
        if not lead:
            return None
        full = build()
        full.load_state_dict(sd)
        return full

    augment_version = getattr(train_cat, "augment_sketches", 0)
    flip = augment_version > 0
    aug_gen = torch.Generator(device=device).manual_seed(args.seed)
    resize_mode = None if args.resize_mode == "auto" else args.resize_mode

    def device_batches(catalog, train: bool):
        loader = TripletLoader(catalog, args.batch_size, args.image_size,
                               resize_mode=resize_mode,
                               shard=(d_rank, n_data) if n_data > 1
                               else None)

        def gen():
            for batch in loader:
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}
                b = len(batch["sketch"])
                yield finish_triplet_batch(
                    batch, aug_gen,
                    augment_version=augment_version if train else 0,
                    flip=flip if train else False, train=train,
                    rows=(d_rank * b, n_data * b) if n_data > 1 else None)

        return gen

    param_dict = {
        "model": args.model or "fresh-init", "dataset": args.dataset,
        "epochs": args.epochs, "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "weight_decay": args.weight_decay,
        "optimizer": "Adam", "loss_fn": "TripletMarginLoss",
        "loss_margin": args.loss_margin, "loss_type": args.loss_type,
        "loss_weights": [loss_cfg.classification_weight,
                         loss_cfg.classification_weight2],
        "model_type": args.model_type, "num_classes": args.num_classes,
        "num_classes2": num_classes2, "image_size": args.image_size,
        "width": args.width, "layers": list(args.layers),
        "resize_mode": resize_mode
        or getattr(train_cat, "resize_mode", "square"),
        "n_devices": world, "tp_devices": int(args.tp_devices),
    }
    data_dict = train_cat.state_dict
    say(param_dict, flush=True)
    say(data_dict, flush=True)
    gallery_mesh = _gallery_mesh(devices) if lead else None

    def embed(m):
        replicas = {d: m if d == device else copy.deepcopy(m).to(d)
                    for d in ([] if gallery_mesh is None
                              else gallery_mesh.distinct_devices())}

        def forward(images_uint8):
            net = replicas.get(images_uint8.device, m)
            return net(finish_gallery_batch(images_uint8))
        return forward

    training_dict = {}
    if not args.no_training:
        mgr = None
        start_epoch = 0
        if args.checkpoint_dir:
            mgr = CheckpointManager(args.checkpoint_dir)
            if args.resume and mgr.latest_step() is not None:
                state.load_state_dict(mgr.restore())
                start_epoch = int(mgr.latest_step())
                say(f"Resumed from epoch {start_epoch}", flush=True)
                multihost.broadcast_state(model, state.optimizer)

        epoch_hook = None
        if args.eval_every_epoch:
            def epoch_hook(epoch: int, st) -> dict:
                out = {}
                net = one_device(st.model)
                if lead:
                    d = run_inference(
                        embed(net), test_cat, None, args.loss_type,
                        image_size=args.image_size, resize_mode=resize_mode,
                        model_name=model_name, save_features=False,
                        device=device, mesh=gallery_mesh)
                    stats = d.get("drawing_stats", d)
                    out = {"mrr": float(stats["mean_reciprocal_rank"]),
                           "top1": float(stats["topk_acc"][0]),
                           "top10": float(stats["topk_acc"][9]),
                           "rank_mean": float(stats["mean"])}
                multihost.barrier()
                return out

        trainer = TripletTrainer(
            loss_cfg, args.batch_size, args.epochs,
            checkpoint_manager=mgr,
            checkpoint_every_epochs=args.checkpoint_every,
            epoch_hook=epoch_hook)
        with maybe_profile(args.trace_dir if lead else None):
            state, training_dict = trainer.run(
                state, device_batches(train_cat, True),
                device_batches(test_cat, False), start_epoch=start_epoch,
                log=lambda line: say(line, flush=True))
    model = one_device(model)
    if not lead:
        return None  # rank 0 alone evaluates and writes

    bn_sketch_stats = None
    if args.bn_recalibrate != "off":
        out = recalibrate_from_catalog(
            model, train_cat, mode=args.bn_recalibrate,
            image_size=args.image_size,
            resize_mode=resize_mode or getattr(train_cat, "resize_mode",
                                               "square"),
            batch_size=args.batch_size, max_batches=args.bn_sweep_batches,
            device=device)
        if args.bn_recalibrate == "mixed":
            model.load_state_dict(out, strict=False)
        else:  # per_modality: the gallery (the main export) takes photos'
            bn_sketch_stats, photo_stats = out
            model.load_state_dict(photo_stats, strict=False)
        training_dict["bn_recalibrate"] = args.bn_recalibrate
        print(f"BN running stats recalibrated ({args.bn_recalibrate})",
              flush=True)

    inference_dict = {}
    if args.inference:
        query_forward = (None if bn_sketch_stats is None
                         else embed(with_stats(model, bn_sketch_stats)))
        kq = None
        name = test_cat.state_dict["dataset"]
        if "Kaggle" in name or "Mixed" in name:
            try:
                _, kq = get_datasets("KaggleInferenceV1",
                                     sketch_type="sketches",
                                     root=args.data_root)
            except FileNotFoundError:
                kq = None
        inference_dict = run_inference(
            embed(model), test_cat, args.feature_folder, args.loss_type,
            image_size=args.image_size, resize_mode=resize_mode,
            model_name=model_name, kaggle_queries=kq,
            query_forward_fn=query_forward, device=device, mesh=gallery_mesh)

    writer = ResultsWriter(model_name, data_dict["dataset"],
                           root=args.results_root)
    if training_dict:
        save_state_dict(checkpoint_path("models", writer.run_name),
                        model.state_dict())
        if bn_sketch_stats is not None:
            # the sketch set rides in a sibling export for the queries
            save_state_dict(
                checkpoint_path("models", f"{writer.run_name}_bn_sketch"),
                bn_sketch_stats)
        print(f"Model saved as {writer.run_name}", flush=True)
    writer.write_all(data_dict, training_dict, param_dict, inference_dict)
    visualize(writer.path, training_dict, inference_dict)
    print(f"Data saved in {writer.path}", flush=True)
    return writer.path


if __name__ == "__main__":
    main()
