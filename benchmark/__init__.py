"""The benchmark of the PyTorch port (``tacotronv2_wavernn_chinese_tpu_torch``)
on NVIDIA GPUs.

One command runs one cell once::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (whose ``kind`` names the driver module in
``drivers/``), and each per-layer metric in ``metrics/<metric>.py``.
Nothing here imports JAX or the JAX package.
"""
