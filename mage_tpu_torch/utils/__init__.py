from mage_tpu_torch.utils.metrics import MetricsWriter
from mage_tpu_torch.utils.timer import Timer
