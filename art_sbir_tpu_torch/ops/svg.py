"""Host-side SVG <-> stroke-5 conversion of the Sketchy vector sketches.

The port's own copy of ``art_sbir_tpu/ops/svg.py``, line for line the
same: a re-implementation of the reference SVG handler
(`semiSupervised_utils/svg_handler.py`).

* ``parse_svg``: extract the black (#000) paths, skipping the white erase
  paths but counting them (`svg_handler.py:136-150`); tokenize on the
  ``c``/``l`` commands; approximate each cubic bezier by a line to its
  endpoint (`svg_handler.py:166-171`); movetos are absolute and become
  deltas; merge strokes by ``reduce_factor`` until the sequence fits
  ``max_length`` (`svg_handler.py:109-124`); truncate; shift the pen
  states one step earlier (`svg_handler.py:68-69`: each pen state
  describes the *next* stroke); cache the result dict as JSON.
* ``build_svg``: stroke-5 -> a one-path SVG (``l``/``m`` commands),
  stopping at the end token.
* ``reshape_vector_sketch``: rescale deltas from the original canvas to
  256 x 256.

Pure Python on the host: it feeds the cached catalog; the rasterization
of the resulting tensors is :mod:`art_sbir_tpu_torch.ops.rasterize`.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

_PATH_BLACK = re.compile(r'<path.*?\sd="([^"]+)"[^#]*#000[^/]*/>', re.DOTALL)
_PATH_WHITE = re.compile(r'<path.*?\sd="([^"]+)"[^#]*#fff[^/]*/>', re.DOTALL)
_SHAPE = re.compile(r'<svg\swidth="(\d+)"\sheight="(\d+)"')


def build_svg(stroke5_rows: Sequence[Sequence[float]], shape: Tuple[int, int],
              result_path: Optional[Path | str] = None) -> str:
    """Stroke-5 -> minimal SVG string (reference `svg_handler.py:11-27`)."""
    head = (
        f'<svg width="{shape[0]}" height="{shape[1]}" '
        'xmlns="http://www.w3.org/2000/svg" xmlns:svg="http://www.w3.org/2000/svg" '
        'xmlns:xlink="http://www.w3.org/1999/xlink">\n <g display="inline">\n '
        "<title>Layer 1</title>\n \n"
    )
    d = ""
    for row in stroke5_rows:
        if row[4]:
            break
        if row[2]:
            d += f"l{row[0]},{row[1]}"
        elif row[3]:
            d += f"m{row[0]},{row[1]}"
    svg = (
        head
        + f'<path d="{d}" id="path" stroke-width="2" stroke="#000" fill="none"/>\n'
        + "</g>\n </svg>\n"
    )
    if result_path:
        Path(result_path).write_text(svg)
    return svg


def _tokenize(path: str) -> List[str]:
    """Split one path's d-attribute into move/line/bezier tokens
    (reference `svg_handler.py:156-164`)."""
    tokens: List[str] = []
    for part in path.split("c"):
        tokens.extend(part.split("l"))
    return tokens


def _token_to_delta(token: str) -> Tuple[float, float, bool]:
    """-> (dx, dy, is_move). Bezier tokens keep only their endpoint pair
    (reference `svg_handler.py:166-171`)."""
    is_move = "m" in token
    if not is_move and " " in token.strip():
        token = token.split(" ")[-1]
    xs, ys = token.split(",")
    xs = xs.lstrip("m").strip()
    return float(xs), float(ys), is_move


def reduce_strokes(sketch: List[List[float]], factor: int, max_length: int = 0):
    """Merge runs of up to ``factor`` consecutive pen-down segments; recurse
    until the sketch fits (reference `svg_handler.py:109-124`)."""
    if len(sketch) <= max_length:
        return sketch
    reduced = []
    i = 0
    while i < len(sketch):
        start = i
        dx, dy = sketch[i][0], sketch[i][1]
        while (
            i + 1 < len(sketch)
            and sketch[i][2]
            and sketch[i + 1][2]
            and i - start < factor
        ):
            i += 1
            dx, dy = dx + sketch[i][0], dy + sketch[i][1]
        reduced.append([round(dx, 5), round(dy, 5)] + sketch[start][2:5])
        i += 1
    if max_length and factor > 1 and len(reduced) < len(sketch):
        return reduce_strokes(reduced, factor, max_length)
    return reduced


def parse_svg(
    filename: Path | str,
    result_dir: Optional[Path | str] = None,
    reduce_factor: int = 1,
    max_length: int = 100,
) -> Dict:
    """Sketchy SVG -> stroke-5 dict (reference `svg_handler.py:30-76`)."""
    filename = Path(filename)
    svg = filename.read_text()
    paths = _PATH_BLACK.findall(svg)
    erase = len(_PATH_WHITE.findall(svg))
    w, h = _SHAPE.findall(svg)[0]
    shape = (int(w), int(h))

    rows: List[List[float]] = []
    x, y = 0.0, 0.0
    for path in paths:
        for token in _tokenize(path):
            dx, dy, is_move = _token_to_delta(token)
            if is_move:  # movetos are absolute -> convert to delta
                dx, dy = round(dx - x, 5), round(dy - y, 5)
                pen_touched, pen_lifted = 0, 1
            else:
                pen_touched, pen_lifted = 1, 0
            x, y = x + dx, y + dy
            rows.append([dx, dy, pen_touched, pen_lifted, 0])

    result = {
        "filename": str(filename),
        "shape": shape,
        "erase_flag": erase,
        "max_len": max_length,
        "reduce_factor": reduce_factor,
        "image": rows,
        "original_length": len(rows),
    }

    result["image"] = reduce_strokes(result["image"], reduce_factor, max_length)
    if max_length and len(result["image"]) > max_length:
        result["image"] = result["image"][:max_length]

    # pen state of step i describes the transition INTO step i+1
    img = result["image"]
    for i in range(len(img) - 1):
        img[i][2:] = img[i + 1][2:]

    if result_dir:
        # written whole, then renamed: ranks that parse one corpus at once
        # never read a half-written cache
        out = Path(result_dir) / f"{filename.stem}.json"
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(result))
        os.replace(tmp, out)
    return result


def load_vector_sketch(filename: Path | str) -> Dict:
    return json.loads(Path(filename).read_text())


def reshape_vector_sketch(
    vectorized: Dict, img_width: int = 256, img_height: int = 256
) -> Dict:
    """Rescale deltas from the original canvas to (img_width, img_height)
    (reference `svg_handler.py:95-102`)."""
    import numpy as np

    arr = np.asarray(vectorized["image"], np.float32).copy()
    arr[:, 0] = arr[:, 0] / vectorized["shape"][0] * img_width
    arr[:, 1] = arr[:, 1] / vectorized["shape"][1] * img_height
    out = dict(vectorized)
    out["original_shape"] = vectorized["shape"]
    out["shape"] = (img_width, img_height)
    out["image"] = arr
    return out
