"""Command-line entry points of the port, run as ``python -m
bvsc_tpu_torch.cli.<name>``, each on the first CUDA card unless ``--device
cpu``: ``codec_cli`` (``.bvsc`` files), ``export_cli`` (serving bundles),
``serve_daemon`` (BVSP/1), ``train_bvrnn``, ``train_vocoder`` and
``export_bvrnn_npz`` (training), ``synthesize``, ``dump_finetune_mels``,
``select_vocoder_ckpt``, ``evaluate_codec``, ``compare_reference_conditions``
and ``entropy_representativeness`` (synthesis and evaluation);
``validate_pesq`` and ``prepare_demo_data`` run on the host alone."""

# the checkpoint flags' help: the files ``codec.load_bvrnn_checkpoint`` and
# ``codec.load_vocoder_checkpoint`` read
BVRNN_HELP = ("BVRNN checkpoint: a flat .npz (chkpts/), a port trainer's bvrnn_ file or an "
              "upstream {'vrnn': state_dict} .pt")
VOCODER_HELP = ("vocoder checkpoint: a flat .npz (tools/export_vocoder_npz.py), a port trainer's "
                "g_ / do_ file or an upstream BigVGAN g_ file ({'generator': state_dict})")
