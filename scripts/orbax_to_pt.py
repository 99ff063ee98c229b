"""Convert a model the JAX package saved with orbax into the ``.pt`` the
PyTorch port's CLIs take.

    python scripts/orbax_to_pt.py \
        --model_type ModifiedResNet_with_classification --src models/<run>
    python scripts/orbax_to_pt.py --model_type Pix2Pix --src models/<run>

The inverse of ``art_sbir_tpu/cli/port.py`` (reference ``.pth`` -> orbax),
with its ``--model_type`` choices. It restores the tree the JAX package
wrote, maps it through ``art_sbir_tpu_torch/models/port_weights.py``'s
``*_from_flax``, and writes the form each port CLI already reads:

  ModifiedResNet[_with_classification]  {params, batch_stats}
      (``art_sbir_tpu/cli/train.py``'s export)
      -> ``<out>`` = ``<src>.pt`` by default: ``<models_root>/<run>.pt``
         for ``serve``, ``inference`` and ``train --model``; a
         ``<src>_bn_sketch`` sibling ({batch_stats}, the sketch
         population's statistics) -> ``<src>_bn_sketch.pt`` beside it
  DrawingGenerator                      {params}
      -> ``<src>.pt`` for ``cli/drawings.py --model``
  AdaIN                                 {encoder, decoder}
      -> ``<src>_pth/`` holding ``vgg_normalised.pth`` and ``decoder.pth``
         for ``cli/artwork_gen.py --model``
  Photo2Sketch                          {params}
      (``art_sbir_tpu/cli/photo2sketch.py``'s export)
      -> ``<src>.pt`` for ``cli/photo2sketch.py --model``
  Pix2Pix                               {g: {params, batch_stats}, d: ...}
      (``art_sbir_tpu/cli/pix2pix.py``'s export; resnet_9blocks or
      unet_256) -> ``<src>.pt`` holding {"G": ..., "D": ...} for
      ``cli/pix2pix.py --model``

Depths (the ResNet's stages, the residual blocks, the U-Net's levels,
the discriminator's layers) are read from the tree. It needs orbax, and
so JAX: run it where the JAX package runs (the port imports neither) and
carry the ``.pt`` to the card's machine. The resumable train states of
JAX's ``CheckpointManager`` (optimizer moments, step) are not converted:
the port's trainers start their own.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from art_sbir_tpu_torch.models import port_weights as PW  # noqa: E402

MODEL_TYPES = ("ModifiedResNet", "ModifiedResNet_with_classification",
               "DrawingGenerator", "AdaIN", "Photo2Sketch", "Pix2Pix")


def restore(path: Path) -> Dict[str, Any]:
    """The orbax tree at ``path`` as nested dicts of numpy arrays, restored
    on the CPU against the shapes its own metadata records."""
    import jax
    import orbax.checkpoint as ocp

    path = path.absolute()
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path).item_metadata.tree
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree_util.tree_map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu), meta)
    tree = ckptr.restore(path, abstract)
    return jax.tree_util.tree_map(np.asarray, tree)


def _count(tree: Mapping, pattern: str) -> int:
    return sum(1 for k in tree if re.fullmatch(pattern, k))


def resnet_layers(params: Mapping) -> Tuple[int, ...]:
    """The blocks a stage of a flax ``ModifiedResNet`` tree."""
    stages = sorted({int(k[5:].split("_")[0]) for k in params
                     if k.startswith("layer")})
    return tuple(_count(params, rf"layer{s}_\d+") for s in stages)


def convert_encoder(tree: Mapping, with_classification: bool
                    ) -> Dict[str, torch.Tensor]:
    params, stats = tree["params"], tree["batch_stats"]
    if ("backbone" in params) != with_classification:
        kind = "with" if "backbone" in params else "without"
        raise SystemExit(f"the tree is a ModifiedResNet {kind} classifier "
                         "heads: pass the other --model_type")
    if with_classification:
        return PW.modified_resnet_with_classification_from_flax(
            params, stats, resnet_layers(params["backbone"]))
    return PW.modified_resnet_from_flax(params, stats, resnet_layers(params))


def convert_pix2pix(tree: Mapping, net_g: str | None = None,
                    norm: str | None = None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The G and D state dicts. The generator's kind and norm are read
    from the tree (``UnetSkipBlock_*`` present: unet_256; batch
    statistics present: batch norm) and printed; ``net_g`` and ``norm``,
    where given, must agree with them."""
    g, d = tree["g"], tree["d"]
    g_params, g_stats = g["params"], g.get("batch_stats", {})
    kind = ("unet_256" if any(k.startswith("UnetSkipBlock") for k in g_params)
            else "resnet_9blocks")
    found = "batch" if g_stats else "instance"
    if net_g not in (None, kind):
        raise SystemExit(f"--net_g {net_g}: the tree holds a {kind} "
                         "generator")
    if norm not in (None, found):
        raise SystemExit(f"--norm {norm}: the tree's generator has "
                         f"{found} norm")
    print(f"Pix2Pix generator: --net_g {kind} --norm {found}", flush=True)
    net_g = kind
    sd_g = PW.pix2pix_g_from_flax(
        net_g, g_params, g_stats,
        n_blocks=_count(g_params, r"ResnetBlock_\d+"),
        num_downs=_count(g_params, r"UnetSkipBlock_\d+"))
    d_params, d_stats = d["params"], d.get("batch_stats", {})
    n_convs = _count(d_params, r"Conv_\d+")
    if np.asarray(d_params["Conv_0"]["kernel"]).shape[0] == 1:
        sd_d = PW.pix2pix_d_from_flax("pixel", d_params, d_stats)
    else:
        sd_d = PW.pix2pix_d_from_flax("n_layers", d_params, d_stats,
                                      n_layers=n_convs - 2)
    return {"G": sd_g, "D": sd_d}


def convert(model_type: str, src: Path, out: Path | None = None,
            net_g: str | None = None, norm: str | None = None) -> list:
    """Convert ``src``; returns the paths written (``net_g`` and
    ``norm``: :func:`convert_pix2pix`)."""
    tree = restore(src)
    written = []

    def save(obj, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(obj, path)
        written.append(path)

    default = src.parent / f"{src.name}.pt"
    if model_type.startswith("ModifiedResNet"):
        out = out or default
        save(convert_encoder(tree, model_type.endswith("classification")),
             out)
        sibling = src.parent / f"{src.name}_bn_sketch"
        if sibling.is_dir():
            stats = restore(sibling)["batch_stats"]
            stats = stats.get("backbone", stats)
            save(PW.modified_resnet_stats_from_flax(stats,
                                                    resnet_layers(stats)),
                 out.parent / f"{out.stem}_bn_sketch.pt")
    elif model_type == "DrawingGenerator":
        params = tree["params"]
        save(PW.drawing_from_flax(params, _count(params, r"res\d+")),
             out or default)
    elif model_type == "AdaIN":
        out = out or src.parent / f"{src.name}_pth"
        enc, dec = PW.adain_from_flax(tree["encoder"], tree["decoder"])
        save(enc, out / "vgg_normalised.pth")
        save(dec, out / "decoder.pth")
    elif model_type == "Photo2Sketch":
        save(PW.photo2sketch_from_flax(tree["params"]), out or default)
    else:
        save(convert_pix2pix(tree, net_g, norm), out or default)
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="convert a JAX package orbax export to the port's .pt "
                    "(model weights only: a resumable train state's "
                    "optimizer moments are not converted)")
    p.add_argument("--model_type", required=True, choices=MODEL_TYPES)
    p.add_argument("--src", required=True,
                   help="the orbax directory (e.g. models/<run>)")
    p.add_argument("--out", default=None,
                   help="output .pt (AdaIN: a directory); default beside "
                        "--src: <src>.pt, or <src>_pth/ for AdaIN")
    p.add_argument("--net_g", default=None,
                   choices=["resnet_9blocks", "unet_256"],
                   help="Pix2Pix: read from the tree when omitted; "
                        "refused where the tree disagrees")
    p.add_argument("--norm", default=None, choices=["batch", "instance"],
                   help="Pix2Pix: read from the tree when omitted; "
                        "refused where the tree disagrees")
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    src = Path(args.src)
    if not src.is_dir():
        raise SystemExit(f"--src {src}: not an orbax directory")
    written = convert(args.model_type, src,
                      Path(args.out) if args.out else None, args.net_g,
                      args.norm)
    for path in written:
        print(f"Converted {args.model_type} {src} -> {path}", flush=True)
    return written


if __name__ == "__main__":
    main()
