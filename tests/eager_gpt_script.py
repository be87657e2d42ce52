"""A paddle-style eager GPT training loop, written once against the
public API both packages share: `P` is ``paddle_tpu`` or
``paddle_tpu_torch``. It imports neither, so the card's machine (which
has no JAX) runs it from chip_smoke.py's phase 22 as the CPU tests run
it on both packages (tests/torch_port_helpers.py re-exports it).

The script is GPTForCausalLM's forward written out in Tensors and
registered ops (pre-norm blocks, fused qkv [q | k | v], tied LM head,
tanh GELU, causal attention through the scaled_dot_product_attention
op, no dropout), its loss the mean next-token cross-entropy, then
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``."""
import numpy as np

# parameter names as GPTForCausalLM's state_dict has them
EMB = "gpt.embeddings.word_embeddings.weight"
POS = "gpt.embeddings.position_embeddings.weight"
FINAL = "gpt.final_norm"


def layer_names(i):
    pre = f"gpt.layers.{i}."
    return {k: pre + v for k, v in (
        ("ln1_w", "ln1.weight"), ("ln1_b", "ln1.bias"),
        ("qkv_w", "attn.qkv_proj.weight"), ("qkv_b", "attn.qkv_proj.bias"),
        ("out_w", "attn.out_proj.weight"), ("out_b", "attn.out_proj.bias"),
        ("ln2_w", "ln2.weight"), ("ln2_b", "ln2.bias"),
        ("fc1_w", "mlp.fc1.weight"), ("fc1_b", "mlp.fc1.bias"),
        ("fc2_w", "mlp.fc2.weight"), ("fc2_b", "mlp.fc2.bias"))}


def gpt_loss(P, params, ids, labels, num_layers, num_heads, eps=1e-5):
    """Mean next-token loss of the GPT whose Tensors `params` holds
    (named as GPTForCausalLM's state_dict) on int Tensors `ids` and
    `labels` [b, s]."""
    F = P.nn.functional
    b, s = ids.shape
    h = params[EMB].shape[1]
    d = h // num_heads
    pos = P.arange(s)
    x = F.embedding(ids, params[EMB]) + F.embedding(pos, params[POS])
    for i in range(num_layers):
        n = {k: params[v] for k, v in layer_names(i).items()}
        y = F.layer_norm(x, n["ln1_w"], n["ln1_b"], eps)
        qkv = F.linear(y, n["qkv_w"], n["qkv_b"]).reshape(
            [b, s, 3, num_heads, d])
        q, k, v = qkv.unbind(2)
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + F.linear(a.reshape([b, s, h]), n["out_w"], n["out_b"])
        y = F.layer_norm(x, n["ln2_w"], n["ln2_b"], eps)
        y = F.gelu(F.linear(y, n["fc1_w"], n["fc1_b"]), approximate=True)
        x = x + F.linear(y, n["fc2_w"], n["fc2_b"])
    x = F.layer_norm(x, params[FINAL + ".weight"], params[FINAL + ".bias"],
                     eps)
    logits = P.matmul(x, params[EMB], transpose_y=True)
    return F.cross_entropy(logits, labels, reduction="none").mean()


def eager_gpt_steps(P, weights, batches, num_layers, num_heads, lr=1e-3,
                    weight_decay=0.01, amp=False, place=None, on_step=None):
    """Train the GPT `weights` ({state_dict name: array or tensor}) for
    one AdamW step per (ids, labels) of `batches` (numpy int arrays), in
    bf16 O1 `auto_cast` when `amp`. Returns (losses as floats, params:
    {name: Tensor}). `on_step(i)` runs before step i (a hook for timers
    and counters)."""
    params = {k: P.to_tensor(w, place=place, stop_gradient=False)
              for k, w in weights.items()}
    opt = P.optimizer.AdamW(learning_rate=lr, parameters=list(
        params.values()), weight_decay=weight_decay)
    losses = []
    for i, (ids, labels) in enumerate(batches):
        if on_step is not None:
            on_step(i)
        ids_t = P.to_tensor(np.asarray(ids, np.int32), place=place)
        labels_t = P.to_tensor(np.asarray(labels, np.int32), place=place)
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            loss = gpt_loss(P, params, ids_t, labels_t, num_layers,
                            num_heads)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, params
