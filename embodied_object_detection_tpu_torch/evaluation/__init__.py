"""COCO bbox evaluation on the host."""

from .coco_eval import COCOEvaluator, coco_ap
