"""Training: the BVRNN VAE trainer (``bvrnn_train``), the vocoder GAN
trainer (``vocoder_train``), their optimizer (``optim``) and checkpoints
(``checkpoint``)."""
