"""The /v1/completions wire schema: OpenAI-completions-shaped, token-id
native.

This framework serves raw language models (no tokenizer ships with the
engine), so ``prompt`` is a list of token ids and completions come back
as token ids — the shape any OpenAI-style client library can drive once
pointed at ids instead of text.  ``parse_completion_request`` maps the
JSON body onto ``LLMEngine.add_request`` kwargs with hard validation (a
frontend must reject garbage before it costs engine work), and the
``completion_*`` helpers render the non-streaming response and the SSE
stream frames.

Request fields (POST /v1/completions, application/json):

    prompt              [int] token ids (required, non-empty)
    max_tokens          int, default 16
    temperature         float, default 0 (greedy)
    top_k / top_p       sampling knobs (engine semantics)
    repetition_penalty  float, default 1.0
    seed                int, default 0
    stop_token_id       int eos override (optional)
    spec_k              per-request speculative draft length (optional)
    stream              bool — SSE token stream vs one JSON body
    deadline_ms         per-request wall budget, queue wait included
                        (optional; server default applies otherwise)

Streaming frames mirror OpenAI's: ``data: {json}\\n\\n`` per token with
``choices[0].token`` the new token id, then a final frame carrying
``finish_reason``, then ``data: [DONE]``.
"""
from __future__ import annotations

import json

__all__ = ["ProtocolError", "parse_completion_request",
           "completion_response", "stream_token_frame",
           "stream_finish_frame", "error_body"]


class ProtocolError(ValueError):
    """Invalid request body → HTTP 400 with a JSON error."""


def _require(cond, msg):
    if not cond:
        raise ProtocolError(msg)


def parse_completion_request(body: bytes):
    """Parse + validate the JSON body.  Returns (engine_kwargs, stream,
    deadline_ms) where engine_kwargs feeds LLMEngine.add_request via
    EngineRunner.submit."""
    try:
        obj = json.loads(body.decode("utf-8") or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"body is not valid JSON: {e}") from e
    _require(isinstance(obj, dict), "body must be a JSON object")

    prompt = obj.get("prompt")
    _require(isinstance(prompt, list) and prompt,
             "'prompt' must be a non-empty list of token ids")
    _require(all(isinstance(t, int) and not isinstance(t, bool)
                 for t in prompt),
             "'prompt' must contain integer token ids")

    def _num(name, default, kind, lo=None, hi=None):
        v = obj.get(name, default)
        _require(isinstance(v, (int, float)) and not isinstance(v, bool),
                 f"'{name}' must be a number")
        v = kind(v)
        _require(lo is None or v >= lo, f"'{name}' must be >= {lo}")
        _require(hi is None or v <= hi, f"'{name}' must be <= {hi}")
        return v

    kwargs = {
        "prompt": [int(t) for t in prompt],
        "max_new_tokens": _num("max_tokens", 16, int, lo=1),
        "temperature": _num("temperature", 0.0, float, lo=0.0),
        "top_k": _num("top_k", 0, int, lo=0),
        "top_p": _num("top_p", 1.0, float),
        "repetition_penalty": _num("repetition_penalty", 1.0, float),
        "seed": _num("seed", 0, int),
    }
    _require(0.0 < kwargs["top_p"] <= 1.0, "'top_p' must be in (0, 1]")
    _require(kwargs["repetition_penalty"] > 0.0,
             "'repetition_penalty' must be > 0")
    if obj.get("stop_token_id") is not None:
        kwargs["eos_token_id"] = _num("stop_token_id", None, int, lo=0)
    if obj.get("spec_k") is not None:
        kwargs["spec_k"] = _num("spec_k", None, int, lo=0)

    stream = obj.get("stream", False)
    _require(isinstance(stream, bool), "'stream' must be a boolean")
    deadline_ms = obj.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = _num("deadline_ms", None, float, lo=1.0)
    return kwargs, stream, deadline_ms


def _finish_reason(out) -> str:
    # engine reasons "eos" -> OpenAI "stop"; "length" passes through;
    # abort reasons ("aborted"/"deadline"/"shutdown") pass through so
    # clients can tell WHY a stream ended early
    return "stop" if out.finish_reason == "eos" else out.finish_reason


def completion_response(request_id: str, model: str, out) -> bytes:
    """Non-streaming response body."""
    return json.dumps({
        "id": request_id,
        "object": "text_completion",
        "model": model,
        "choices": [{
            "index": 0,
            "token_ids": list(out.generated),
            "finish_reason": _finish_reason(out),
        }],
        "usage": {
            "prompt_tokens": len(out.prompt),
            "completion_tokens": len(out.generated),
            "total_tokens": len(out.prompt) + len(out.generated),
        },
    }).encode("utf-8")


def stream_token_frame(request_id: str, model: str, token: int) -> str:
    return json.dumps({
        "id": request_id,
        "object": "text_completion.chunk",
        "model": model,
        "choices": [{"index": 0, "token": int(token),
                     "finish_reason": None}],
    })


def stream_finish_frame(request_id: str, model: str, out) -> str:
    return json.dumps({
        "id": request_id,
        "object": "text_completion.chunk",
        "model": model,
        "choices": [{"index": 0, "token": None,
                     "finish_reason": _finish_reason(out)}],
        "usage": {
            "prompt_tokens": len(out.prompt),
            "completion_tokens": len(out.generated),
            "total_tokens": len(out.prompt) + len(out.generated),
        },
    })


def error_body(status: int, message: str, *, kind: str = "invalid_request",
               ) -> bytes:
    return json.dumps({"error": {"message": message, "type": kind,
                                 "code": int(status)}}).encode("utf-8")
