"""The port's pretrain manifest builders and box utilities against the JAX
package's: the four corpora over synthetic on-disk layouts (with and
without images on disk), `write_manifest` and the sources CLI give the same
records and bytes; BoxMode, Boxes, pairwise_iou, quantize_bbox,
patchify_image and ObjectCenterCrop give the same numbers and pixels.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from mafed_tpu.pretrain import sources as jsrc
from mafed_tpu.utils import boxes as jboxes
from mafed_tpu_torch.pretrain import sources as tsrc
from mafed_tpu_torch.utils import boxes as tboxes


def _touch_img(path, w=8, h=8):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(path)


def _layout(root, source):
    """A synthetic on-disk layout of `source` under `root`, some images missing."""
    if source == "coco":
        os.makedirs(root / "annotations")
        ann = {"images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"}],
               "annotations": [{"image_id": 1, "caption": "a cat"}, {"image_id": 1, "caption": "a feline"},
                               {"image_id": 2, "caption": "a dog"}, {"image_id": 99, "caption": "orphan"}]}
        (root / "annotations" / "captions_train2014.json").write_text(json.dumps(ann))
        _touch_img(str(root / "train2014" / "a.jpg"))
    elif source == "visual_genome":
        os.makedirs(root)
        regions = [{"regions": [
            {"image_id": 7, "phrase": "red ball", "x": 1, "y": 2, "width": 3, "height": 4},
            {"image_id": 7, "phrase": "blue box", "x": 5, "y": 6, "width": 7, "height": 8},
            {"image_id": 9, "phrase": "no image", "x": 0, "y": 0, "width": 1, "height": 1}]}]
        (root / "region_descriptions.json").write_text(json.dumps(regions))
        (root / "image_data.json").write_text(json.dumps([{"image_id": 7, "url": "https://vg.org/VG_100K/7.jpg"}]))
        _touch_img(str(root / "VG_100K" / "7.jpg"))
    elif source == "cc3m":
        os.makedirs(root)
        (root / "Train_GCC-training.tsv").write_text("first caption\thttp://x/1.jpg\nsecond caption\thttp://x/2.jpg\n"
                                                     "\thttp://x/3.jpg\n")
        _touch_img(str(root / "images" / "0.jpg"))
    else:
        os.makedirs(root)
        (root / "sbu-captions-all.json").write_text(json.dumps(
            {"image_urls": ["http://s/img7.jpg", "http://s/img8.jpg"], "captions": ["on a beach", "a boat"]}))
        _touch_img(str(root / "images" / "img7.jpg"))


def _rows(records):
    return [dataclasses.asdict(r) for r in records]


@pytest.mark.parametrize("require_images", [True, False], ids=["images_on_disk", "no_require_images"])
@pytest.mark.parametrize("source", ["coco", "visual_genome", "cc3m", "sbu"])
def test_builders_match_jax(tmp_path, source, require_images):
    _layout(tmp_path / source, source)
    assert sorted(tsrc.SOURCE_BUILDERS) == sorted(jsrc.SOURCE_BUILDERS)
    got = tsrc.SOURCE_BUILDERS[source](str(tmp_path / source), require_images=require_images)
    want = jsrc.SOURCE_BUILDERS[source](str(tmp_path / source), require_images=require_images)
    assert got and _rows(got) == _rows(want)


def test_manifest_and_cli_match_jax(tmp_path):
    for source in ("coco", "visual_genome"):
        _layout(tmp_path / source, source)
    outs = {}
    for name, mod in (("jax", jsrc), ("torch", tsrc)):
        out = str(tmp_path / f"{name}.jsonl")
        n_coco = mod.main(["--source", "coco", "--root", str(tmp_path / "coco"), "--out", out])
        n_vg = mod.main(["--source", "visual_genome", "--root", str(tmp_path / "visual_genome"), "--out", out,
                         "--append", "--no_require_images"])
        outs[name] = (n_coco, n_vg, open(out).read())
    assert outs["torch"] == outs["jax"] and outs["torch"][:2] == (2, 3)
    # write_manifest alone, then appended
    for name, mod, rec in (("jax", jsrc, jsrc.CaptionRecord), ("torch", tsrc, tsrc.CaptionRecord)):
        path = str(tmp_path / f"w_{name}.jsonl")
        mod.write_manifest([rec(image="x", caption="one", source="sbu_captions", metadata={"k": [1, 2]})], path)
        mod.write_manifest([rec(image="y", caption="two")], path, append=True)
    assert open(tmp_path / "w_torch.jsonl").read() == open(tmp_path / "w_jax.jsonl").read()


BOX_CASES = [
    ([[10.0, 20.0, 50.0, 80.0]], (100, 200)),
    ([[0.0, 0.0, 1.0, 1.0], [3.5, 2.25, 7.0, 9.5], [5, 5, 5, 5]], (40, 30)),
]


@pytest.mark.parametrize("boxes,size", BOX_CASES, ids=["one_box", "three_boxes"])
def test_box_utilities_match_jax(boxes, size):
    for src in tboxes.BoxMode:
        for dst in tboxes.BoxMode:
            np.testing.assert_array_equal(tboxes.BoxMode.convert(boxes, src, dst, image_size=size),
                                          jboxes.BoxMode.convert(boxes, jboxes.BoxMode(int(src)),
                                                                 jboxes.BoxMode(int(dst)), image_size=size))
    tb, jb = tboxes.Boxes(boxes), jboxes.Boxes(boxes)
    np.testing.assert_array_equal(tb.area(), jb.area())
    np.testing.assert_array_equal(tb.clip((8, 8)).tensor, jb.clip((8, 8)).tensor)
    np.testing.assert_array_equal(tb.nonempty(), jb.nonempty())
    other = [[5, 5, 15, 15], [20, 20, 30, 30], [0, 0, 0, 0]]
    np.testing.assert_array_equal(tboxes.pairwise_iou(tb, tboxes.Boxes(other)),
                                  jboxes.pairwise_iou(jb, jboxes.Boxes(other)))
    for bins in (10, 1000):
        np.testing.assert_array_equal(tboxes.quantize_bbox(boxes, size, num_bins=bins),
                                      jboxes.quantize_bbox(boxes, size, num_bins=bins))


def test_patchify_matches_jax():
    img = np.random.default_rng(0).normal(size=(2, 3, 9, 7)).astype(np.float32)  # ragged edges dropped
    for patch in ({"height": 2, "width": 2}, {"height": 3, "width": 7}):
        np.testing.assert_array_equal(tboxes.patchify_image(img, patch), jboxes.patchify_image(img, patch))


@pytest.mark.parametrize("bbox", [[150, 100, 250, 200], [0, 0, 20, 20], [380, 280, 400, 300], [10, 5, 30, 25]])
def test_object_center_crop_matches_jax(bbox):
    from PIL import Image

    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, size=(300, 400, 3), dtype=np.uint8))
    small = Image.fromarray(rng.integers(0, 256, size=(60, 80, 3), dtype=np.uint8))  # smaller than the crop
    for size in ((100, 100), (224, 224)):
        t, j = tboxes.ObjectCenterCrop(size), jboxes.ObjectCenterCrop(size)
        for im in (img, small):
            assert t.crop_window(im.size, bbox) == j.crop_window(im.size, bbox)
            np.testing.assert_array_equal(np.asarray(t(im, bbox)), np.asarray(j(im, bbox)))
