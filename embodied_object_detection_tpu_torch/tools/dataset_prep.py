"""Dataset-preparation tools (Detic tools/ analogs).

The port's counterpart of the repository's `tools/dataset_prep.py`, with
the same functions and subcommands; it reads the port's own vendored
metadata (`data/metadata/`) and embeds vocabularies with the port's CLIP
text tower, on the card unless `--device cpu`.

Subcommands:

  cat-info   annotate a COCO/LVIS json's categories with image and
             instance counts (+ r/c/f frequency buckets): the federated
             loss's frequency table (ref: Detic/tools/get_lvis_cat_info.py;
             read by models/losses.py:fed_loss_class_weight)
  clip-features
             embed class names with the CLIP text tower into a zs_weight
             .npy (ref: Detic/tools/dump_clip_features.py: 'a <name>'
             prompts, [C, 512] f32)
  merge-lvis-coco
             COCO annotations merged into an LVIS json
             (ref: Detic/tools/merge_lvis_coco.py)
  imagenet-tar-json
             the dataset-records json of a directory of ImageNet tars
             (ref: Detic/tools/get_imagenet_21k_full_tar_json.py)
  cc-tags    category tags mined from captions, the CC3M `_tags` json
             (ref: Detic/tools/get_cc_tags.py)
  remove-rare
             an LVIS json without its rare categories' annotations
             (ref: Detic/tools/remove_lvis_rare.py)
  coco-zeroshot-oriorder
             a zero-shot split with the full original-order category table
             (ref: Detic/tools/get_coco_zeroshot_oriorder.py)

Usage:
  python -m embodied_object_detection_tpu_torch.tools.dataset_prep \\
      cat-info --ann lvis_train.json --add-freq
  CLIP_BPE_PATH=bpe_simple_vocab_16e6.txt.gz \\
  python -m embodied_object_detection_tpu_torch.tools.dataset_prep \\
      clip-features --names names.json --clip-params clip.pth \\
      --out zs_weight.npy [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import sys
from collections import defaultdict

import numpy as np

from ..data.tar_dataset import build_tar_index
from ..evaluation.coco_eval import _iou_xywh

METADATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "metadata")


def _metadata(name: str):
    with open(os.path.join(METADATA_DIR, name)) as f:
        return json.load(f)


def cat_info(ann_path: str, add_freq: bool = False, r_thresh: int = 10,
             c_thresh: int = 100, out_path: str = None) -> list:
    """Each category of `ann_path` with its `image_count` and
    `instance_count` (and with `add_freq`, its r/c/f `frequency`), written
    to `out_path` (default `<ann>_cat_info.json`) and returned."""
    with open(ann_path) as f:
        data = json.load(f)
    cats = data["categories"]
    image_count = {x["id"]: set() for x in cats}
    ann_count = {x["id"]: 0 for x in cats}
    for x in data["annotations"]:
        image_count[x["category_id"]].add(x["image_id"])
        ann_count[x["category_id"]] += 1
    for x in cats:
        x["image_count"] = len(image_count[x["id"]])
        x["instance_count"] = ann_count[x["id"]]
        if add_freq:
            freq = "f"
            if x["image_count"] < c_thresh:
                freq = "c"
            if x["image_count"] < r_thresh:
                freq = "r"
            x["frequency"] = freq
    out_path = out_path or ann_path[:-5] + "_cat_info.json"
    with open(out_path, "w") as f:
        json.dump(cats, f)
    return cats


def clip_features(names, out_path: str, clip_weights: str = None,
                  bpe_path: str = None, prompt: str = "a {}",
                  encoder=None, device: str = "cuda") -> np.ndarray:
    """Class names -> [C, 512] f32 embeddings of `prompt` (one a name),
    saved to `out_path` (dump_clip_features.py saves [C, D]; run.py's
    zs_weight loader transposes to [D, C+1] and appends the background
    column). `encoder` defaults to `load_default_text_encoder(
    clip_weights, bpe_path, device)`: the tower on the card unless
    `device` is "cpu"."""
    if encoder is None:
        from ..models.text_encoder import load_default_text_encoder
        encoder = load_default_text_encoder(clip_weights, bpe_path, device)
    emb = encoder([prompt.format(n) for n in names])
    np.save(out_path, np.asarray(emb, np.float32))
    return emb


def merge_coco_into_lvis(coco_data: dict, lvis_data: dict,
                         synset_table=None, iou_thresh: float = 0.7) -> dict:
    """COCO annotations merged into an LVIS json
    (Detic/tools/merge_lvis_coco.py:112-202): COCO categories map to LVIS
    ids through the synset table (default: the vendored
    `coco_synset_categories.json`); an annotation whose category is in its
    image's `neg_category_ids` is dropped, and a COCO box over a
    same-image, SAME-category LVIS box at IoU >= `iou_thresh` is a
    duplicate (cross-category overlaps are kept, merge_lvis_coco.py:
    185-195). Images match by their file name's last 16 characters.
    Returns the merged LVIS-format dict."""
    if synset_table is None:
        synset_table = _metadata("coco_synset_categories.json")
    synset2lvisid = {x["synset"]: x["id"] for x in lvis_data["categories"]}
    coco2lvis = {x["coco_cat_id"]: synset2lvisid[x["synset"]]
                 for x in synset_table if x["synset"] in synset2lvisid}

    def tail(name):
        return name[-16:]

    file_key = "file_name" if any(
        "file_name" in x for x in lvis_data["images"][:1]) else "coco_url"
    lvis_file2img = {tail(x[file_key]): x for x in lvis_data["images"]}
    coco_id2img = {x["id"]: x for x in coco_data["images"]}

    coco_img2anns = defaultdict(list)
    for ann in coco_data["annotations"]:
        fn = tail(coco_id2img[ann["image_id"]]["file_name"])
        if ann["category_id"] not in coco2lvis or fn not in lvis_file2img:
            continue
        lvis_img = lvis_file2img[fn]
        lvis_cat = coco2lvis[ann["category_id"]]
        if lvis_cat in lvis_img.get("neg_category_ids", []):
            continue
        coco_img2anns[fn].append(dict(ann, category_id=lvis_cat,
                                      image_id=lvis_img["id"]))

    lvis_id2img = {x["id"]: x for x in lvis_data["images"]}
    lvis_img2anns = defaultdict(list)
    for ann in lvis_data["annotations"]:
        lvis_img2anns[tail(lvis_id2img[ann["image_id"]][file_key])].append(
            ann)

    merged, ann_id = [], 0
    # the union: an LVIS image without positive annotations (the federated
    # split) can still take mapped COCO annotations
    for fn in sorted(set(lvis_img2anns) | set(coco_img2anns)):
        lvis_anns = lvis_img2anns.get(fn, [])
        keep = list(lvis_anns)
        coco_anns = coco_img2anns.get(fn, [])
        if coco_anns:
            ious = _iou_xywh(
                np.array([a["bbox"] for a in coco_anns], np.float64),
                np.array([a["bbox"] for a in lvis_anns], np.float64)
                if lvis_anns else np.zeros((0, 4)))
            for i, ann in enumerate(coco_anns):
                dup = any(ious[i, j] >= iou_thresh and
                          ann["category_id"] == lvis_anns[j]["category_id"]
                          for j in range(len(lvis_anns)))
                if not dup:
                    keep.append(ann)
        for ann in keep:
            ann_id += 1
            merged.append(dict(ann, id=ann_id))
    out = dict(lvis_data)
    out["annotations"] = merged
    return out


def imagenet_tar_json(tar_dir: str, out_path: str,
                      categories=None) -> dict:
    """The dataset-records json of `tar_dir/*.tar` for the tar ImageNet
    pipeline (Detic/tools/get_imagenet_21k_full_tar_json.py): one image
    record a tar member, labelled with its tar's index, read by
    `data/tar_dataset.py:DiskTarDataset` and the weak-supervision mapper.
    Writes each tar's member index beside it."""
    images, cats = [], []
    for ti, tar in enumerate(sorted(glob.glob(os.path.join(tar_dir,
                                                           "*.tar")))):
        names_npy, _ = build_tar_index(tar, tar_dir)
        cats.append({"id": ti,
                     "name": os.path.splitext(os.path.basename(tar))[0]})
        for member in np.load(names_npy):
            images.append({"id": len(images),
                           "file_name": str(member),
                           "tar_index": ti,
                           "pos_category_ids": [ti]})
    out = {"images": images,
           "categories": categories or cats,
           "annotations": []}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out


def map_tag_name(x: str) -> str:
    """Synonym -> the surface form matched in captions (get_cc_tags.py:
    92-97): underscores to spaces, a parenthetical stripped, lower case."""
    x = x.replace("_", " ")
    if "(" in x:
        x = x[: x.find("(")]
    return x.lower().strip()


def cc_tags(cc_data: dict, categories=None, allcaps: bool = False,
            keep_images: bool = False) -> dict:
    """Category tags mined from captions -> the cc3m `_tags` json
    (Detic/tools/get_cc_tags.py:99-195): each category's synonyms,
    space-padded, are matched as substrings of the lower-cased caption
    (and at its start and end); images gain `pos_category_ids`, and
    untagged images are dropped unless `keep_images`. `categories`
    defaults to the json's own, else the vendored LVIS v1 table.
    Categories without `synonyms` (COCO-style tables) take the LVIS
    synonyms of their COCO id's synset (get_cc_tags.py:126-133)."""
    cc_data = copy.deepcopy(cc_data)
    if categories is not None:
        cc_data["categories"] = copy.deepcopy(categories)
    if "categories" not in cc_data:
        cc_data["categories"] = _metadata("lvis_v1_categories.json")
    cats = cc_data["categories"]
    if cats and "synonyms" not in cats[0]:
        cocoid2synset = {x["coco_cat_id"]: x["synset"]
                         for x in _metadata("coco_synset_categories.json")}
        synset2synonyms = {x["synset"]: x["synonyms"]
                           for x in _metadata("lvis_v1_train_cat_info.json")}
        for c in cats:
            c["synonyms"] = synset2synonyms[cocoid2synset[c["id"]]]
            c["frequency"] = "f"
    for c in cats:
        c.setdefault("synonyms", [c["name"]])
    class_data = {c["id"]: [" " + map_tag_name(s) + " "
                            for s in c["synonyms"]] for c in cats}
    images = []
    for x in cc_data["images"]:
        caption = (" ".join(x["captions"]) if allcaps
                   else x["captions"][0]).lower()
        x["pos_category_ids"] = []
        for cat_id, names in class_data.items():
            for c in names:
                if c in caption or caption.startswith(c[1:]) \
                        or caption.endswith(c[:-1]):
                    x["pos_category_ids"].append(cat_id)
                    break
        if x["pos_category_ids"] or keep_images:
            images.append(x)
    return {"images": images, "categories": cats, "annotations": []}


def remove_rare(lvis_data: dict, exclude=("r",)) -> dict:
    """The annotations of categories whose frequency is in `exclude`
    dropped (the `_norare` split; ref: Detic/tools/remove_lvis_rare.py)."""
    catid2freq = {c["id"]: c.get("frequency", "f")
                  for c in lvis_data["categories"]}
    out = dict(lvis_data)
    out["annotations"] = [a for a in lvis_data["annotations"]
                          if catid2freq[a["category_id"]] not in exclude]
    return out


def coco_zeroshot_oriorder(data: dict, full_categories) -> dict:
    """A zero-shot split's category list replaced by the full
    original-order table (ref: Detic/tools/get_coco_zeroshot_oriorder.py)."""
    out = dict(data)
    out["categories"] = full_categories
    return out


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _save(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    ci = sub.add_parser("cat-info")
    ci.add_argument("--ann", required=True)
    ci.add_argument("--add-freq", action="store_true")
    ci.add_argument("--r-thresh", type=int, default=10)
    ci.add_argument("--c-thresh", type=int, default=100)
    ci.add_argument("--out", default=None)
    cf = sub.add_parser("clip-features")
    cf.add_argument("--names", required=True,
                    help="json list of class names")
    cf.add_argument("--clip-params", required=True,
                    help="a CLIP checkpoint (.pth); the BPE merges table "
                         "is CLIP_BPE_PATH")
    cf.add_argument("--out", required=True)
    cf.add_argument("--prompt", default="a {}")
    cf.add_argument("--device", default="cuda",
                    help="device of the text tower: 'cuda' (the default; "
                         "raises without a card) or 'cpu'")
    mg = sub.add_parser("merge-lvis-coco")
    mg.add_argument("--coco", required=True)
    mg.add_argument("--lvis", required=True)
    mg.add_argument("--out", required=True)
    mg.add_argument("--iou-thresh", type=float, default=0.7)
    tj = sub.add_parser("imagenet-tar-json")
    tj.add_argument("--tar-dir", required=True)
    tj.add_argument("--out", required=True)
    ct = sub.add_parser("cc-tags")
    ct.add_argument("--cc-ann", required=True)
    ct.add_argument("--out", required=True)
    ct.add_argument("--cat-path", default="")
    ct.add_argument("--allcaps", action="store_true")
    ct.add_argument("--keep-images", action="store_true")
    nr = sub.add_parser("remove-rare")
    nr.add_argument("--ann", required=True)
    oo = sub.add_parser("coco-zeroshot-oriorder")
    oo.add_argument("--data-path", required=True)
    oo.add_argument("--cat-path", required=True)
    return p


def main(argv=None) -> int:
    args = argument_parser().parse_args(argv)
    if args.cmd == "cat-info":
        cats = cat_info(args.ann, args.add_freq, args.r_thresh,
                        args.c_thresh, args.out)
        print(f"{len(cats)} categories annotated")
    elif args.cmd == "merge-lvis-coco":
        merged = merge_coco_into_lvis(_load(args.coco), _load(args.lvis),
                                      iou_thresh=args.iou_thresh)
        _save(merged, args.out)
        print(f"{len(merged['annotations'])} annotations -> {args.out}")
    elif args.cmd == "imagenet-tar-json":
        out = imagenet_tar_json(args.tar_dir, args.out)
        print(f"{len(out['images'])} images -> {args.out}")
    elif args.cmd == "cc-tags":
        cats = _load(args.cat_path)["categories"] if args.cat_path else None
        out = cc_tags(_load(args.cc_ann), cats, allcaps=args.allcaps,
                      keep_images=args.keep_images)
        _save(out, args.out)
        print(f"{len(out['images'])} tagged images -> {args.out}")
    elif args.cmd == "remove-rare":
        out = remove_rare(_load(args.ann))
        out_path = args.ann[:-5] + "_norare.json"
        _save(out, out_path)
        print(f"{len(out['annotations'])} annotations -> {out_path}")
    elif args.cmd == "coco-zeroshot-oriorder":
        out = coco_zeroshot_oriorder(_load(args.data_path),
                                     _load(args.cat_path)["categories"])
        out_path = args.data_path[:-5] + "_oriorder.json"
        _save(out, out_path)
        print(f"saved -> {out_path}")
    else:
        emb = clip_features(_load(args.names), args.out,
                            clip_weights=args.clip_params,
                            prompt=args.prompt, device=args.device)
        print(f"saved {emb.shape} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
