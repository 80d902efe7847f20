"""Cluster capacity for elastic training (the counterpart of
``ray_tpu/autoscaler/``; only ``elastic.py`` is ported, the node providers
and the autoscaler loop are ROADMAP.md, Queue 1 item 16)."""
