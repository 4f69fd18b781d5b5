"""Training data: the synthetic world (``synthetic``, over ``image_ops``),
device-resident pools (``device_data``) and on-device augmentation
(``device_augment``) (counterpart of ``loans_tpu.data``)."""
