"""Command-line tools ported from colmap_tpu/tools: model, rig and SfM tools."""
