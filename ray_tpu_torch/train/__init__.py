"""ray_tpu_torch.train — the counterpart of ``ray_tpu.train``.

Only the exactly-once sample ledger is ported so far (``elastic.py``), for
streaming ingest; the Trainer, its sessions and profiler come later
(ROADMAP.md, Queue 1 item 5).
"""
