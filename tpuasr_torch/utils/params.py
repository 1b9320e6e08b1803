"""Per-model hyperparameter presets: the port's copy of
``tpuasr/utils/params.py`` (the same names and values, a test holds them
equal). ``preset_for`` gives a model's kwargs and the ``TrainConfig``
fields it overrides."""

from __future__ import annotations

# model name -> (model_kwargs, train overrides)
MODEL_PRESETS: dict = {
    "deepspeech_ctc": (
        dict(rnn_hidden=512, rnn_layers=4, conv_channels=32, dropout=0.1),
        dict(optimizer="adamw", lr=3e-4, grad_clip=5.0),
    ),
    "deepspeech_var": (
        # "var" variant: deeper/narrower recurrent stack.
        dict(rnn_hidden=384, rnn_layers=6, conv_channels=32, dropout=0.1),
        dict(optimizer="adamw", lr=3e-4, grad_clip=5.0),
    ),
    "resnet_ctc": (
        dict(stem_channels=32, stage_channels=(32, 64, 128, 256),
             blocks_per_stage=2, dropout=0.1),
        dict(optimizer="adamw", lr=5e-4, grad_clip=5.0),
    ),
    "resnet_ed": (
        dict(stem_channels=32, stage_channels=(32, 64, 128),
             blocks_per_stage=2, dec_hidden=256, emb_dim=128, dropout=0.1),
        dict(optimizer="adamw", lr=5e-4, grad_clip=5.0,
             objective="seq2seq_ce"),
    ),
    "capsule1": (
        dict(conv_channels=64, primary_caps=16, primary_dim=8,
             class_dim=16, routing_iters=3),
        dict(optimizer="adam", lr=1e-3, grad_clip=5.0),
    ),
    "ssvae": (
        dict(latent_dim=32, hidden=(256, 256)),
        dict(optimizer="adam", lr=1e-3, objective="framewise_ce"),
    ),
}


def preset_for(model: str) -> tuple[dict, dict]:
    """(model_kwargs, train_overrides) for a model name; empty if unknown."""
    kwargs, train = MODEL_PRESETS.get(model, ({}, {}))
    return dict(kwargs), dict(train)
