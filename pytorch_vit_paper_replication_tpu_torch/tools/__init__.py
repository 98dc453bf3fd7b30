"""Command-line tools of the port (``python -m
pytorch_vit_paper_replication_tpu_torch.tools.<name>``)."""
