"""Host-side utilities (counterpart of ldt_tpu/tools): configs and the
YAML reader (`io`), CSV and text logging (`log`), seeding, meters and
normalization (`utils`)."""

from ldt_torch.tools.io import (
    dict2namespace,
    load_yaml,
    makedirs,
    namespace2dict,
)

__all__ = ["dict2namespace", "load_yaml", "makedirs", "namespace2dict"]
