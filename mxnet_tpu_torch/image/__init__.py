"""Image API (counterpart of ``mxnet_tpu.image``)."""
from .image import (imread, imdecode, imresize, fixed_crop, random_crop,
                    center_crop, color_normalize, random_size_crop,
                    resize_short, scale_down, copyMakeBorder, ImageIter,
                    Augmenter, SequentialAug, RandomOrderAug, CastAug,
                    ResizeAug, ForceResizeAug, RandomCropAug,
                    RandomSizedCropAug, CenterCropAug, HorizontalFlipAug,
                    BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, ColorJitterAug, LightingAug,
                    ColorNormalizeAug, CreateAugmenter)
