"""COCO bbox evaluation on the host; the OpenImages evaluator is
`evaluation.oid_eval`."""

from .coco_eval import COCOEvaluator, coco_ap
