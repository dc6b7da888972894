"""Launchers: ``python -m repro_torch.launch.serve --arch hymba-1.5b``,
``python -m repro_torch.launch.train --arch smollm-360m``."""
