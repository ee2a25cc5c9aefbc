"""On-device camera rendering: raycast rasterizer + procedural weather (port of
``cilrs_tpu/render``), every env's camera at once."""
