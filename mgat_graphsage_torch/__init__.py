"""M-GAT-GraphSAGE on PyTorch and CUDA (Hopper, sm_90a).

The port of ``mgat_graphsage_tpu`` (the JAX reference, which it does not
import).  It covers the flagship's serving path: SMILES ->
featurisation and ECFP-1024 on the host (the native C++ featuriser,
``csrc/featurizer.cpp``, built with ``g++`` at first use) -> dense adjacency
(``csrc/adjacency.cu``) -> ModifiedGAT with fused masked attention
(``csrc/attention.cu``) -> SAGEConv -> masked max pool, beside the
fingerprint CNN -> fusion head -> pChEMBL; and its f32 training path, which
adds the attention backward (``csrc/attention_bwd.cu``) and, with
``cnn_pallas_bwd``, the CNN branch's fused backward (``csrc/cnn_dy3.cu``,
``csrc/cnn_chain_bwd.cu``); compact device storage of the training set
(``data/packed.py``); and the HTTP server (``serve.py``).

    from mgat_graphsage_torch.train import Trainer, get_config
    Trainer(get_config("flagship"), train_ds, val_ds).fit()   # on CUDA
    from mgat_graphsage_torch.eval import Predictor
    Predictor("ckpt.pt")(["CCO"])            # on CUDA
    Predictor("ckpt.pt", device="cpu")(...)  # plain PyTorch on the CPU
    python -m mgat_graphsage_torch.serve ckpt.pt --port 8080

Importing the package builds nothing; each kernel is compiled with
``nvcc`` at its first launch (``ops/_build.py``), and the featuriser with
``g++`` at its first call (``chem/native.py``).
"""

__version__ = "0.1.0"
