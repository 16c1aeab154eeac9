"""Command-line tools of the port: `dataset_prep` makes the vocabularies
and the LVIS, COCO, CC3M and ImageNet jsons that training reads."""
