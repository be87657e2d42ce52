"""A paddle-style GPT built from ``nn.Layer``s and trained eagerly,
written once against the public API both packages share: `P` is
``paddle_tpu`` or ``paddle_tpu_torch``. It imports neither, so the
card's machine (which has no JAX) runs it from chip_smoke.py's phase 22
as the CPU tests run it on both packages.

``build_gpt`` makes GPTForCausalLM out of ``P.nn.Layer`` subclasses:
``P.nn.Embedding`` (word and position), pre-norm blocks of
``P.nn.LayerNorm`` and ``P.nn.Linear`` (fused qkv [q | k | v]), causal
attention through the scaled_dot_product_attention op, tanh GELU, a
final LayerNorm and the LM head tied to the word embeddings. Its
``state_dict()`` keys are GPTForCausalLM's, so weights go in by
``set_state_dict``. ``layer_gpt_steps`` trains it with
``AdamW(parameters=model.parameters())``, ``loss.backward()``,
``opt.step()`` and ``opt.clear_grad()``: the same ops in the same order
as tests/eager_gpt_script.py and GPTForCausalLM."""
import numpy as np

EMB = "gpt.embeddings.word_embeddings.weight"
POS = "gpt.embeddings.position_embeddings.weight"


def build_gpt(P, vocab_size, hidden_size, num_layers, num_heads,
              max_position, eps=1e-5):
    """A GPT of Layers with GPTForCausalLM's structure and names, its
    parameters drawn by the layers' defaults on the default place."""
    nn = P.nn
    F = nn.functional
    head_dim = hidden_size // num_heads

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv_proj = nn.Linear(hidden_size, 3 * hidden_size)
            self.out_proj = nn.Linear(hidden_size, hidden_size)

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv_proj(x).reshape([b, s, 3, num_heads, head_dim])
            q, k, v = qkv.unbind(2)
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.out_proj(a.reshape([b, s, hidden_size]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(hidden_size, 4 * hidden_size)
            self.fc2 = nn.Linear(4 * hidden_size, hidden_size)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden_size, eps)
            self.attn = Attention()
            self.ln2 = nn.LayerNorm(hidden_size, eps)
            self.mlp = MLP()

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            return x + self.mlp(self.ln2(x))

    class Embeddings(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
            self.position_embeddings = nn.Embedding(max_position,
                                                    hidden_size)

        def forward(self, ids):
            pos = P.arange(ids.shape[1])
            return self.word_embeddings(ids) + self.position_embeddings(pos)

    class Body(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embeddings = Embeddings()
            self.layers = nn.LayerList([Block() for _ in range(num_layers)])
            self.final_norm = nn.LayerNorm(hidden_size, eps)

        def forward(self, ids):
            x = self.embeddings(ids)
            for layer in self.layers:
                x = layer(x)
            return self.final_norm(x)

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = Body()

        def forward(self, ids):
            x = self.gpt(ids)
            return P.matmul(x, self.gpt.embeddings.word_embeddings.weight,
                            transpose_y=True)

    return GPT()


def gpt_from_weights(P, weights, num_layers, num_heads):
    """``build_gpt`` at the widths of `weights` ({state_dict name: array
    or tensor}), loaded with them by ``set_state_dict``."""
    vocab, hidden = weights[EMB].shape
    model = build_gpt(P, int(vocab), int(hidden), num_layers, num_heads,
                      int(weights[POS].shape[0]))
    missing, unexpected = model.set_state_dict(weights)
    assert not missing and not unexpected, (missing, unexpected)
    return model


def layer_gpt_loss(P, model, ids, labels):
    """Mean next-token loss of `model` on int Tensors `ids` and `labels`
    [b, s]."""
    logits = model(ids)
    return P.nn.functional.cross_entropy(logits, labels,
                                         reduction="none").mean()


def train_steps(P, model, opt, batches, amp=False, place=None,
                on_step=None):
    """One step of `opt` on `model` per (ids, labels) of `batches` (numpy
    int arrays), in bf16 O1 ``auto_cast`` when `amp`; the losses as
    floats. `on_step(i)` runs before step i."""
    losses = []
    for i, (ids, labels) in enumerate(batches):
        if on_step is not None:
            on_step(i)
        ids_t = P.to_tensor(np.asarray(ids, np.int32), place=place)
        labels_t = P.to_tensor(np.asarray(labels, np.int32), place=place)
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            loss = layer_gpt_loss(P, model, ids_t, labels_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def layer_gpt_steps(P, weights, batches, num_layers, num_heads, lr=1e-3,
                    weight_decay=0.01, amp=False, place=None, on_step=None):
    """Build the Layer GPT on the default place from `weights`, then
    train it for one AdamW step per batch (``train_steps``). Returns
    (losses, model, optimizer)."""
    model = gpt_from_weights(P, weights, num_layers, num_heads)
    opt = P.optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                            weight_decay=weight_decay)
    losses = train_steps(P, model, opt, batches, amp=amp, place=place,
                         on_step=on_step)
    return losses, model, opt


def saved_arrays(path):
    """The file ``P.save(model.state_dict(), path)`` wrote, read with
    pickle and numpy alone: {name: array}. Raises AssertionError when an
    entry is not in the saved-Tensor form both packages write
    (``{"__paddle_tpu_tensor__": True, "data": ndarray,
    "stop_gradient": bool, "name": ...}``)."""
    import pickle
    with open(path, "rb") as f:
        obj = pickle.load(f)
    assert isinstance(obj, dict), type(obj)
    out = {}
    for k, v in obj.items():
        assert isinstance(v, dict) and v.get("__paddle_tpu_tensor__") is \
            True, (k, type(v))
        assert isinstance(v["data"], np.ndarray), (k, type(v["data"]))
        assert isinstance(v["stop_gradient"], bool), k
        out[k] = v["data"]
    return out


def round_trip(P, model, path, batch, num_layers, num_heads, lr=1e-3,
               weight_decay=0.01, amp=False, place=None):
    """Save `model`'s state_dict to `path`, check the file's form with
    pickle and numpy alone, load it into a fresh model by
    ``set_state_dict(P.load(path))``, then take one more step on each
    model from the same batch, each with a fresh AdamW. Returns
    (saved arrays, the loaded model, (its loss, the original's))."""
    P.save(model.state_dict(), path)
    arrays = saved_arrays(path)
    fresh = build_gpt(P, *arrays[EMB].shape, num_layers, num_heads,
                      arrays[POS].shape[0])
    missing, unexpected = fresh.set_state_dict(P.load(path))
    assert not missing and not unexpected, (missing, unexpected)
    losses = []
    for m in (fresh, model):
        opt = P.optimizer.AdamW(learning_rate=lr, parameters=m.parameters(),
                                weight_decay=weight_decay)
        losses.append(train_steps(P, m, opt, [batch], amp=amp,
                                  place=place)[0])
    return arrays, fresh, tuple(losses)
