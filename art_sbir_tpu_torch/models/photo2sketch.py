"""Photo2Sketch VAE (PyTorch, NCHW): a VGG16 encoder and an attention-LSTM
stroke decoder.

Counterpart of ``art_sbir_tpu/models/photo2sketch.py`` (reference
`models.py:16-181`):

* :class:`EncoderCNN`: VGG16 features, a max over H and W, then the
  ``fc_mu`` and ``fc_std`` heads (``log_var``; `models.py:35-49`);
* :class:`AttentionCell2D`: additive attention over the feature map,
  ``tanh(conv_f(feat) + conv_h(h))`` -> one logit a position -> a softmax
  over the H W positions -> the weighted sum of the raw features
  (`models.py:148-181`). ``conv_f(feat)`` does not change across the
  decoder's steps, so :meth:`AttentionCell2D.embed` computes it once
  before the loop;
* :class:`DecoderRNN2D`: the teacher-forced decode feeds ``[start;
  sketch]`` for T + 1 steps and predicts T + 1 parameter sets
  (`models.py:79-100`); :meth:`DecoderRNN2D.generate` is the greedy
  autoregressive decode (`models.py:102-144`). Both step in a Python
  loop; a step is the attention, the attention output concatenated with
  the stroke, and one LSTM cell step from the ``nn.LSTM``'s own
  parameters (``x W_ih^T + b_ih + h W_hh^T + b_hh``, gates i, f, g, o;
  JAX ``layers.py:41-66``). The mixture comes back as a
  :class:`~art_sbir_tpu_torch.ops.gmm.GMMParams`.

The state-dict keys are the reference's, so a reference checkpoint loads
with ``load_state_dict``: ``Image_Encoder.feature.<i>`` (torchvision's
``vgg16().features`` indices), ``Image_Encoder.fc_mu``/``fc_std``,
``Sketch_Decoder.fc_hc``/``fc_params``, ``Sketch_Decoder.lstm.{weight,
bias}_{ih,hh}_l0`` and ``Sketch_Decoder.attention_cell.{conv_f, conv_h,
conv_att}`` (JAX ``torch_port.py::port_photo2sketch``).

``dtype=torch.bfloat16`` computes VGG in bf16; the heads, the decoder and
the losses take its features in the parameters' dtype, as flax's
``Dense`` and ``Conv`` promote a bf16 input with float32 parameters.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from art_sbir_tpu_torch.models.vgg import VGGFeatures
from art_sbir_tpu_torch.ops.gmm import GMMParams, split_decoder_output

START_TOKEN = (0.0, 0.0, 1.0, 0.0, 0.0)  # the "move" start (models.py:67)
FEATURES = 512  # VGG16's last stage
EMBEDDING = 256  # the attention's width (models.py:148-181)
Noise = Union[torch.Tensor, torch.Generator]


def _normal(noise: Noise, like: torch.Tensor) -> torch.Tensor:
    """``noise`` as it is, or N(0, 1) of ``like``'s shape drawn from the
    generator ``noise`` (on the generator's device)."""
    if isinstance(noise, torch.Generator):
        noise = torch.randn(like.shape, generator=noise,
                            device=noise.device, dtype=like.dtype)
    return noise.to(like.device, like.dtype)


class EncoderCNN(nn.Module):
    def __init__(self, z_size: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature = VGGFeatures(dtype=dtype)
        self.fc_mu = nn.Linear(FEATURES, z_size)
        self.fc_std = nn.Linear(FEATURES, z_size)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW image -> (feature map (B, 512, h, w) in the parameters'
        dtype, mu, log_var)."""
        feat = self.feature(x).to(self.fc_mu.weight.dtype)
        pooled = torch.amax(feat, dim=(2, 3))  # AdaptiveMaxPool2d(1)
        return feat, self.fc_mu(pooled), self.fc_std(pooled)


class AttentionCell2D(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv_f = nn.Conv2d(FEATURES, EMBEDDING, 3, padding=1)
        self.conv_h = nn.Linear(hidden, EMBEDDING)
        self.conv_att = nn.Linear(EMBEDDING, 1)

    def embed(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loop-invariant part, once: (conv_f embedding (B, HW, E),
        the flat features (B, HW, C)), positions in row-major order."""
        x_em = self.conv_f(feat).flatten(2).transpose(1, 2)
        return x_em, feat.flatten(2).transpose(1, 2)

    def attend(self, x_em: torch.Tensor, tokens: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step: (attention output (B, C), weights (B, HW))."""
        scores = self.conv_att(torch.tanh(x_em + self.conv_h(h)[:, None]))
        alpha = torch.softmax(scores, dim=1)  # (B, HW, 1)
        return (alpha.transpose(1, 2) @ tokens)[:, 0], alpha[..., 0]


class DecoderRNN2D(nn.Module):
    def __init__(self, z_size: int = 128, dec_rnn_size: int = 512,
                 num_mixture: int = 20):
        super().__init__()
        self.num_mixture = num_mixture
        self.fc_hc = nn.Linear(z_size, 2 * dec_rnn_size)
        self.lstm = nn.LSTM(FEATURES + 5, dec_rnn_size)
        self.fc_params = nn.Linear(dec_rnn_size, 6 * num_mixture + 3)
        self.attention_cell = AttentionCell2D(dec_rnn_size)

    def _init_state(self, z: torch.Tensor):
        return torch.tanh(self.fc_hc(z)).chunk(2, dim=-1)

    def _gates(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The (B, 4H) gate pre-activations ``x W_ih^T + b_ih + h W_hh^T +
        b_hh``; under tensor parallelism each rank computes its rows of
        the gate matrices' and the slices are gathered."""
        lstm = self.lstm
        tp = getattr(lstm, "tp", None)
        if tp is not None:
            x, h = tp.copy(x), tp.copy(h)
        gates = (F.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)
                 + F.linear(h, lstm.weight_hh_l0, lstm.bias_hh_l0))
        return gates if tp is None else tp.gather(gates, -1)

    def _step(self, h, c, stroke, x_em, tokens):
        att, alpha = self.attention_cell.attend(x_em, tokens, h)
        x = torch.cat([att, stroke], dim=-1)
        i, f, g, o = self._gates(x, h).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c, alpha

    def _start(self, b: int, like: torch.Tensor) -> torch.Tensor:
        return like.new_tensor(START_TOKEN).expand(b, 5)

    def forward(self, feat: torch.Tensor, z: torch.Tensor,
                sketch: torch.Tensor) -> GMMParams:
        """Teacher-forced decode of ``sketch`` (B, T, 5): GMMParams with
        leading (B, T + 1)."""
        b, t, _ = sketch.shape
        inputs = torch.cat([self._start(b, sketch)[:, None], sketch], dim=1)
        h, c = self._init_state(z)
        x_em, tokens = self.attention_cell.embed(feat)
        hiddens = []
        for s in range(t + 1):
            h, c, _ = self._step(h, c, inputs[:, s], x_em, tokens)
            hiddens.append(h)
        y = self.fc_params(torch.stack(hiddens, dim=1))
        return split_decoder_output(y, self.num_mixture)

    def generate(self, feat: torch.Tensor, z: torch.Tensor, num_steps: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode: at each step the mean of the most likely
        component (argmax of log pi) and a one-hot of the most likely pen
        state; ties take the first index, as JAX's argmax. Returns
        (strokes (B, num_steps, 5), attention (B, num_steps, HW))."""
        b = z.shape[0]
        h, c = self._init_state(z)
        stroke = self._start(b, z)
        x_em, tokens = self.attention_cell.embed(feat)
        strokes, alphas = [], []
        for _ in range(num_steps):
            h, c, alpha = self._step(h, c, stroke, x_em, tokens)
            p = split_decoder_output(self.fc_params(h), self.num_mixture)
            pi_idx = torch.argmax(p.log_pi, dim=-1, keepdim=True)
            pen = F.one_hot(torch.argmax(p.pen_logits, dim=-1), 3)
            stroke = torch.cat([torch.gather(p.mu1, -1, pi_idx),
                                torch.gather(p.mu2, -1, pi_idx),
                                pen.to(z.dtype)], dim=-1)
            strokes.append(stroke)
            alphas.append(alpha)
        return torch.stack(strokes, dim=1), torch.stack(alphas, dim=1)


class Photo2Sketch(nn.Module):
    """The VAE (reference `models.py:16-32`): :meth:`forward` is the
    training path (encode, reparameterize, teacher-forced decode),
    :meth:`generate` the greedy decode."""

    def __init__(self, z_size: int = 128, dec_rnn_size: int = 512,
                 num_mixture: int = 20, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Image_Encoder = EncoderCNN(z_size, dtype)
        self.Sketch_Decoder = DecoderRNN2D(z_size, dec_rnn_size, num_mixture)

    def forward(self, image: torch.Tensor, sketch: torch.Tensor, eps: Noise
                ) -> Tuple[GMMParams, torch.Tensor, torch.Tensor]:
        """``eps`` is the reparameterization noise, (B, z_size), or a
        seeded ``torch.Generator`` that draws it."""
        feat, mu, log_var = self.Image_Encoder(image)
        z = mu + torch.exp(0.5 * log_var) * _normal(eps, mu)
        return self.Sketch_Decoder(feat, z, sketch), mu, log_var

    def generate(self, image: torch.Tensor, num_steps: int,
                 sample_z: bool = False,
                 generator: Optional[Noise] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode from ``z = mu`` (or a sample with ``sample_z``,
        its noise from ``generator``, a generator or a tensor)."""
        feat, mu, log_var = self.Image_Encoder(image)
        z = mu
        if sample_z:
            z = mu + torch.exp(0.5 * log_var) * _normal(generator, mu)
        return self.Sketch_Decoder.generate(feat, z, num_steps)
