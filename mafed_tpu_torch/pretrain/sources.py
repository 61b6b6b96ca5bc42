"""Per-source caption manifest builders: cc3m / coco / visual_genome / sbu
(counterpart of mafed_tpu/pretrain/sources.py).

The reference pretrains on these four sources through a remote-code HF
dataset builder (mafed/data/vl_pythia_pretrain_dataset.py:31-39 with
dataset_subset="vl_pythia_pretrain"; source enum at
mafed/utils/vl_pythia.py:107-152). PretrainDataset consumes a JSONL
manifest instead (pretrain/dataset.py); these builders produce that
manifest from each source's standard on-disk layout, so the same four-corpus
mix is reproducible without network or remote code:

  * coco:          COCO captions annotation JSON (images + annotations) and
                   an image dir of file_name entries
  * visual_genome: region_descriptions.json (+ optional image_data.json for
                   paths); each region becomes one record whose bbox drives
                   the ObjectCenterCrop at load time (boxes.py:477-495)
  * cc3m:          Conceptual Captions TSV (caption<TAB>url) with images
                   downloaded as {row_index}.jpg
  * sbu:           sbu-captions-all.json ({"image_urls": [...],
                   "captions": [...]}) with images named by url basename

CLI: python -m mafed_tpu_torch.pretrain.sources --source coco \
       --root /data/coco --out manifest.jsonl [--append]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Iterable, List, Optional

from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.pretrain.dataset import CaptionRecord


def _exists_or_none(path: str, require_images: bool) -> bool:
    return (not require_images) or os.path.exists(path)


def build_coco(
    root: str,
    annotation_file: str = "annotations/captions_train2014.json",
    image_dir: str = "train2014",
    require_images: bool = True,
) -> List[CaptionRecord]:
    """COCO captions: one record per (image, caption) annotation."""
    with open(os.path.join(root, annotation_file)) as f:
        ann = json.load(f)
    by_id = {img["id"]: img["file_name"] for img in ann["images"]}
    records = []
    for a in ann["annotations"]:
        fname = by_id.get(a["image_id"])
        if fname is None:
            continue
        path = os.path.join(root, image_dir, fname)
        if not _exists_or_none(path, require_images):
            continue
        records.append(CaptionRecord(image=path, caption=a["caption"], source="coco"))
    return records


def build_visual_genome(
    root: str,
    regions_file: str = "region_descriptions.json",
    image_data_file: Optional[str] = "image_data.json",
    image_dir: str = "images",
    require_images: bool = True,
) -> List[CaptionRecord]:
    """VG region descriptions: one record per region, bbox in metadata so the
    loader applies the reference's object-center crop
    (vl_pythia_pretrain_dataset.py:72-83)."""
    paths_by_id: Dict[int, str] = {}
    image_data_path = os.path.join(root, image_data_file) if image_data_file else None
    if image_data_path and os.path.exists(image_data_path):
        with open(image_data_path) as f:
            for img in json.load(f):
                # VG urls end in e.g. .../VG_100K/2.jpg — keep the last two parts
                url = img.get("url", "")
                tail = "/".join(url.rstrip("/").split("/")[-2:]) if url else f"{img['image_id']}.jpg"
                paths_by_id[img["image_id"]] = os.path.join(root, tail)
    with open(os.path.join(root, regions_file)) as f:
        region_sets = json.load(f)
    records = []
    for entry in region_sets:
        for region in entry.get("regions", []):
            image_id = region["image_id"]
            path = paths_by_id.get(image_id, os.path.join(root, image_dir, f"{image_id}.jpg"))
            if not _exists_or_none(path, require_images):
                continue
            bbox = [region["x"], region["y"], region["width"], region["height"]]
            records.append(
                CaptionRecord(
                    image=path,
                    caption=region["phrase"],
                    source="visual_genome",
                    metadata={"bbox": bbox},
                )
            )
    return records


def build_cc3m(
    root: str,
    tsv_file: str = "Train_GCC-training.tsv",
    image_dir: str = "images",
    require_images: bool = True,
) -> List[CaptionRecord]:
    """Conceptual Captions 3M: TSV rows (caption<TAB>url); images stored as
    {row_index}.jpg by the standard download tooling."""
    records = []
    with open(os.path.join(root, tsv_file)) as f:
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            path = os.path.join(root, image_dir, f"{i}.jpg")
            if not _exists_or_none(path, require_images):
                continue
            records.append(
                CaptionRecord(image=path, caption=parts[0], source="conceptual_captions_3m")
            )
    return records


def build_sbu(
    root: str,
    captions_file: str = "sbu-captions-all.json",
    image_dir: str = "images",
    require_images: bool = True,
) -> List[CaptionRecord]:
    """SBU captions: parallel lists of urls + captions; images stored by url
    basename."""
    with open(os.path.join(root, captions_file)) as f:
        data = json.load(f)
    records = []
    for url, caption in zip(data["image_urls"], data["captions"]):
        path = os.path.join(root, image_dir, os.path.basename(url))
        if not _exists_or_none(path, require_images):
            continue
        records.append(CaptionRecord(image=path, caption=caption, source="sbu_captions"))
    return records


SOURCE_BUILDERS: Dict[str, Callable[..., List[CaptionRecord]]] = {
    "coco": build_coco,
    "visual_genome": build_visual_genome,
    "conceptual_captions_3m": build_cc3m,
    "cc3m": build_cc3m,
    "sbu_captions": build_sbu,
    "sbu": build_sbu,
}


def write_manifest(records: Iterable[CaptionRecord], out_path: str, append: bool = False) -> int:
    n = 0
    mode = "a" if append else "w"
    with open(out_path, mode) as f:
        for rec in records:
            f.write(
                json.dumps(
                    {
                        "image": rec.image,
                        "caption": rec.caption,
                        "source": rec.source,
                        "metadata": rec.metadata,
                    }
                )
                + "\n"
            )
            n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source", required=True, choices=sorted(SOURCE_BUILDERS))
    parser.add_argument("--root", required=True, help="source dataset root dir")
    parser.add_argument("--out", required=True, help="output manifest JSONL")
    parser.add_argument("--append", action="store_true", help="append to an existing manifest")
    parser.add_argument(
        "--no_require_images",
        action="store_true",
        help="emit records even when the image file is missing on disk",
    )
    args = parser.parse_args(argv)
    records = SOURCE_BUILDERS[args.source](args.root, require_images=not args.no_require_images)
    n = write_manifest(records, args.out, append=args.append)
    LOGGER.info("%s: wrote %d records to %s", args.source, n, args.out)
    return n


if __name__ == "__main__":
    main()
