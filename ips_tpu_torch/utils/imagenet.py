"""torchvision's ImageNet normalization constants (copy of
ips_tpu/utils/imagenet.py, used by ``input_norm='imagenet'``)."""

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
