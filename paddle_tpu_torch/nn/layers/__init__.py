from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SiLU,
                         Sigmoid, Silu, Softmax, Softmax2D, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear, Pad1D, Pad2D,
                     Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle,
                     Unfold, Upsample, UpsamplingBilinear2D,
                     UpsamplingNearest2D, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D, MaxUnPool2D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from . import activation, common, container, conv, loss, norm, pooling, rnn
from . import transformer

__all__ = (activation.__all__ + common.__all__ + container.__all__
           + ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
              "Conv3D", "Conv3DTranspose"] + loss.__all__ + norm.__all__
           + pooling.__all__ + rnn.__all__
           + ["MultiHeadAttention", "Transformer", "TransformerDecoder",
              "TransformerDecoderLayer", "TransformerEncoder",
              "TransformerEncoderLayer"])
