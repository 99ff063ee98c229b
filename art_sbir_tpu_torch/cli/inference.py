"""Retrieval-evaluation CLI: recompute the inference of saved run folders.

    python -m art_sbir_tpu_torch.cli.inference --folder <run> [--data_root <root>]
        [--device cuda|cpu] [--n_devices N]

Counterpart of ``art_sbir_tpu/cli/inference.py`` (reference
`inference.py:167-244`): read the run's JSONs, restore the encoder from
``<models_root>/<run>.pt`` (a seeded fresh init, with a note, when it is
missing), rebuild the test catalog, evaluate (gallery and queries
embedded by the bf16 encoder, ranked on the card: K1 with ranks from
50,000 gallery rows) and write ``inference_updated.json`` and the plots
into the run folder. ``--n_devices N`` (-1: every card) makes an
encoder replica on each of the first N cards, splits each embedding
batch over them and shards the ranked gallery's rows over them (with
``--device cpu``, N shards on the CPU). ``--bn_recalibrate
mixed|per_modality`` first recalibrates the BatchNorm running statistics
over the run's train split (``train/bn.py``); ``per_modality`` embeds the
queries with the sketches' statistics and the gallery with the photos'.
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path
from typing import Dict

import torch

from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.core.results import load_results
from art_sbir_tpu_torch.parallel.mesh import mesh_from_args
from art_sbir_tpu_torch.retrieval.engine import (rebuild_catalogs,
                                                 restore_encoder,
                                                 run_inference)
from art_sbir_tpu_torch.train.bn import recalibrate_from_catalog, with_stats
from art_sbir_tpu_torch.train.prepare import finish_gallery_batch


def evaluate_folder(folder: str, results_root: Path | str = "results",
                    models_root: Path | str = "models", data_root=None,
                    device: str | torch.device | None = None,
                    feature_root: Path | str = "data/image_features",
                    trace: Dict | None = None, mesh=None,
                    bn_recalibrate: str = "off") -> Dict | None:
    """The run's inference dict (``run_inference`` over its test catalog,
    ``trace`` and ``mesh`` passed on), or None, with a note, when the
    folder has no ``data_params.json``. With a ``mesh``, ``device`` is
    ``mesh.devices[0]`` and each other card of the mesh gets a replica of
    the encoder. ``bn_recalibrate`` (``mixed`` or ``per_modality``)
    recalibrates the BatchNorm statistics over the train split first."""
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    results = load_results(Path(results_root) / folder)
    if "data_params" not in results:
        print(f"Results {folder} are not available", flush=True)
        return None
    data_dict = results["data_params"]
    param_dict = results.get("training_params", {})
    model, restored = restore_encoder(folder, param_dict, models_root, dev)
    if not restored:
        print(f"Model {folder} is not available — evaluating fresh init",
              flush=True)
    train_cat, test_cat = rebuild_catalogs(data_dict, data_root)
    image_size = int(param_dict.get("image_size", 224))

    query_model = model
    if bn_recalibrate != "off":
        out = recalibrate_from_catalog(
            model, train_cat, mode=bn_recalibrate, image_size=image_size,
            resize_mode=(param_dict.get("resize_mode")
                         or getattr(train_cat, "resize_mode", "square")),
            batch_size=int(param_dict.get("batch_size", 32)), device=dev)
        if bn_recalibrate == "mixed":
            model.load_state_dict(out, strict=False)
        else:
            sketch_stats, photo_stats = out
            model.load_state_dict(photo_stats, strict=False)
            query_model = with_stats(model, sketch_stats)
        print(f"BN running stats recalibrated ({bn_recalibrate})",
              flush=True)

    def forward_of(encoder):
        # one encoder a card of the mesh; the forward takes the batch's
        # card's
        replicas = {d: encoder if d == dev else copy.deepcopy(encoder).to(d)
                    for d in ([] if mesh is None
                              else mesh.distinct_devices())}

        def forward(images_uint8):
            return replicas.get(images_uint8.device, encoder)(
                finish_gallery_batch(images_uint8))
        return forward

    # the geometry the run recorded; None -> the catalog family's
    resize_mode = param_dict.get("resize_mode") or data_dict.get("resize_mode")
    return run_inference(
        forward_of(model), test_cat, None,
        param_dict.get("loss_type", "euclidean"), image_size=image_size,
        resize_mode=resize_mode, model_name=type(model).__name__,
        feature_root=feature_root,
        query_forward_fn=(None if query_model is model
                          else forward_of(query_model)),
        device=dev, trace=trace, mesh=mesh)


def rerun_folder(folder: str, results_root: Path | str = "results",
                 models_root: Path | str = "models", data_root=None,
                 device: str | torch.device | None = None,
                 feature_root: Path | str = "data/image_features",
                 trace: Dict | None = None, mesh=None,
                 bn_recalibrate: str = "off") -> None:
    """:func:`evaluate_folder`, then ``inference_updated.json`` and the
    plots into the run folder."""
    inference_dict = evaluate_folder(folder, results_root, models_root,
                                     data_root, device, feature_root, trace,
                                     mesh, bn_recalibrate)
    if inference_dict is None:
        return
    from art_sbir_tpu_torch.viz.plots import visualize

    run_dir = Path(results_root) / folder
    (run_dir / "inference_updated.json").write_text(
        json.dumps(inference_dict, indent=4, default=float))
    visualize(run_dir, load_results(run_dir).get("training", {}),
              inference_dict)
    print(f"RUN INFERENCE AND VISUALIZATION FOR {folder}", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="recomputes Inference for given folder")
    p.add_argument("--folder", default=None)
    p.add_argument("-a", "--all", action="store_true")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--models_root", type=str, default="models")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--feature_root", type=str, default="data/image_features",
                   help="where the embedded gallery's cache is saved")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--n_devices", type=int, default=1,
                   help="cards for the embedding sweep and the sharded "
                        "gallery (1 = one card, -1 = all; N shards on the "
                        "CPU with --device cpu)")
    p.add_argument("--bn_recalibrate", default="off",
                   choices=["off", "mixed", "per_modality"],
                   help="recalibrate BatchNorm running stats over the "
                        "run's train split before evaluating (train/bn.py)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = mesh_from_args(args.n_devices, device=device)
    results_root = Path(args.results_root)
    folders = [args.folder] if args.folder else []
    if args.all:
        folders = [d.name for d in results_root.glob("ModifiedResNet*")
                   if d.is_dir()]
    print(folders, flush=True)
    for folder in folders:
        rerun_folder(folder, results_root, args.models_root, args.data_root,
                     device, args.feature_root, mesh=mesh,
                     bn_recalibrate=args.bn_recalibrate)


if __name__ == "__main__":
    main()
