"""PyTorch/CUDA port of the TPU-native Rainbow-IQN Ape-X framework.

A package of its own beside ``rainbow_iqn_apex_tpu`` (the JAX reference),
importing torch, numpy and the standard library only.  Its device hot path
runs through hand-written Hopper kernels (``csrc/``, bound in ``kernels/``).
Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.

Ported so far: the serving path (``serving.PolicyServer``) at full Atari
width, with the model (``models/``), the weight converter (``convert.py``)
and the act step (``ops/act.py``); ``--role single`` training
(``train.py``, ``ops/learn.py``); ``--role anakin`` with host envs
(``train_anakin.py``) on the device-resident replay (``replay/device.py``);
``--role apex`` on one card (``parallel/apex.py``), sampling the host replay
or, with ``device_sampling``, the device sample frontier
(``replay/frontier.py``); int8 / fp8 serving and actors
(``utils/quantize.py``, ``models/quantized.py``); R2D2 with ``--role
single`` (``train_r2d2.py``, the host ``replay/sequence.py``) and ``--role
anakin`` (``train_anakin_r2d2.py``, the device-resident
``replay/device_sequence.py``).
"""
