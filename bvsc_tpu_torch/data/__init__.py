"""Host-side data handling (numpy and scipy): WAV I/O (``data.audio``),
waveform augmentation (``data.augment``) and the trainers' segment dataset
(``data.dataset``)."""
