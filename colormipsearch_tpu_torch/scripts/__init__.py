"""Command-line tools around the port's CLI, each run as
``python -m colormipsearch_tpu_torch.scripts.<name>``: the tile-grid
launcher of colorDepthSearch (``cds_batch``), the job launcher of
gradientScores (``ga_batch``) and the streaming-memory check of
colorDepthSearch's result writes (``streaming_rss_check``)."""
