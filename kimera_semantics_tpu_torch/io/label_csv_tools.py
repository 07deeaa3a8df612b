"""Label-map CSV utilities, the `join_color_and_id.ipynb` capability.

Counterpart: kimera_semantics_tpu/io/label_csv_tools.py (a copy: the port
imports nothing of the JAX package).

The reference ships a helper notebook
(kimera_semantics_ros/cfg/join_color_and_id.ipynb) that joins an
instance-color CSV with a class-id CSV into the `name,red,green,blue,alpha,id`
format consumed by SemanticLabel2Color. These functions provide that join (and
CSV emission) programmatically.
"""

from __future__ import annotations

import csv
import io
from typing import Dict, Mapping, Sequence, Tuple


def join_color_and_id(color_rows: Sequence[Mapping],
                      id_by_name: Mapping[str, int]) -> str:
    """color_rows: dicts with name,red,green,blue(,alpha); id_by_name: class
    name -> label id. Returns the merged CSV text."""
    out = io.StringIO()
    w = csv.writer(out)
    w.writerow(["name", "red", "green", "blue", "alpha", "id"])
    for row in color_rows:
        name = row["name"]
        if name not in id_by_name:
            raise KeyError(f"no label id for '{name}'")
        w.writerow([name, int(row["red"]), int(row["green"]), int(row["blue"]),
                    int(row.get("alpha", 255)), int(id_by_name[name])])
    return out.getvalue()


def write_label_csv(path: str, label_to_color: Dict[int, Tuple[int, int, int]],
                    names: Mapping[int, str] = None) -> None:
    """Emit a reference-format CSV from a label->RGB dict."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "red", "green", "blue", "alpha", "id"])
        for lab, (r, g, b) in sorted(label_to_color.items()):
            name = names[lab] if names and lab in names else f"class_{lab}"
            w.writerow([name, r, g, b, 255, lab])
