"""Optimizers (updaters) with the reference's semantics and schedules.

Counterpart of cxxnet_tpu/updater (the reference's src/updater/): one
Updater per weight tensor, created per layer by the trainer's visitor walk
(src/updater/updater_impl-inl.hpp:49), applied after each backward.
"""

from .param import UpdaterParam  # noqa: F401
from .updaters import (Updater, create_updater, decode_tag,  # noqa: F401
                       encode_data_key)
