"""External chat-model seam — free-form persona roleplay behind any
completion function.

The reference's ChatBotNode sends the FULL game context to a
temperature-sampled gpt-4.1-mini and posts whatever it says (reference:
agent/game_agent_v2.py:351-466, agent/prompt/chatbot_system_prompt.txt).
This framework's built-in tiers (template composer, distilled on-device LM)
are deterministic and state-faithful but ceiling-bound by the composer's
modes; this module is the documented integration point for open roleplay
beyond them — bring any completion function (an API client, a local
model, a human improviser) and it becomes the TOP tier of the responder:

    external model  >  learned on-device LM (--chat-lm)  >  template composer

The safety invariants hold at every tier, enforced HOST-side so no model
can break them:

- **Hidden values never enter the prompt.** The prompt is built from the
  same visibility-gated boards as the learned tier's context
  (chat.py lm_context) — a model cannot leak what it never sees.
- **Grounded answers are verified before being trusted** (chat.py
  grounded_reply_ok): a visible fact's reply must name the field and
  quote the exact value; a hidden fact's reply must read as a refusal.
  A failed check falls through to the next tier — the learned tiers are
  fail-safe on exactly the queries where being wrong is worst.
- **Dead bots stay silent, bot selection and visibility are host-picked**
  (ChatRoom.plan_reply runs before any model is consulted).
- **Replay is exact.** Bot replies are journaled verbatim
  (manager.post_chat "chat_reply" events), so crash-recovery replay
  reproduces a nondeterministic model's output byte-for-byte without
  re-consulting it.

Environment note: this repo runs with zero network egress, so no client
is shipped; `server.api --chat-llm-cmd / --chat-llm-entry` wire a shell
command or Python entrypoint, and tests exercise the seam with scripted
completion functions (tests/test_chat_llm.py).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

from game_engine_tpu.server.chat import (
    PERSONAS,
    _alive_board,
    _facts_board,
    _fallen_board,
    _score_rows,
)

# one chat bubble, not an essay — the reference prompt asks for "brief,
# in-character" replies (agent/prompt/chatbot_system_prompt.txt)
MAX_REPLY_CHARS = 280

PROMPT_TEMPLATE = """You are roleplaying {bot_name}, a player in the party game "{game}".
Persona: {persona_name} — open with tics like {tic_open!r}, close with {tic_close!r} when it fits.
Current phase: {phase}.
Players still in the game: {alive}.
{fallen_line}Your public standing: {facts}.
{board_line}{know_line}{grounded_block}Recent chat you can see:
{transcript}
{sender_name} says to you: {text!r}

Reply with ONE short in-character chat message (no quotes, no name prefix, under {max_chars} characters). Never invent game facts beyond those listed above."""

GROUNDED_VISIBLE = (
    "The question asks about the field '{fname}' of {subj}. Its actual "
    "value is '{val}' — your reply MUST name the field and quote that "
    "exact value.\n")
GROUNDED_HIDDEN = (
    "The question asks about the field '{fname}' of {subj}, which is "
    "HIDDEN information. Refuse in character — name the field, reveal "
    "NOTHING about its value (you have not been told it).\n")


def roleplay_prompt(plan: dict, snapshot: dict[str, Any],
                    transcript: list[dict[str, Any]],
                    persona: Optional[int] = None,
                    visibility: Optional[dict] = None,
                    game: str = "") -> str:
    """Human-readable roleplay prompt for an external chat model.

    Built from the same visibility-gated boards as the learned tier's
    context (chat.py lm_context), so the two tiers see the same facts:
    the bot's public standing, the alive/fallen rosters, the scoreboard,
    and the bot's OWN private knowledge (vote, investigations) — never
    another player's hidden fields, and never the VALUE of a hidden
    grounded fact (the G-segment rule: withhold, don't trust)."""
    players = snapshot.get("player_states", {})
    bot = plan["bot"]
    me = players.get(str(bot), {})
    pname, opens, closes = PERSONAS[persona % len(PERSONAS)] \
        if persona is not None else ("neutral", ("",), ("",))
    fallen = _fallen_board(players, snapshot.get("deadPlayers", []))
    rows = _score_rows(players)
    board = (", ".join(f"{n} {s}" for n, s in rows[:4])
             if any(s for _, s in rows) else "")
    know = []
    if int(me.get("vote_choice", 0) or 0):
        tgt = str(me["vote_choice"])
        know.append("you voted for "
                    + (players.get(tgt, {}).get("name") or f"Player {tgt}"))
    inv = me.get("investigated_alignments") or {}
    for k, v in sorted(inv.items())[:3]:
        know.append(f"you investigated player {k}: {v}")
    g = plan.get("grounded")
    if g is None:
        gblock = ""
    elif g.get("hidden") or g.get("val") is None:
        gblock = GROUNDED_HIDDEN.format(fname=g["fname"],
                                        subj=g.get("subj", "a player"))
    else:
        gblock = GROUNDED_VISIBLE.format(fname=g["fname"], val=g["val"],
                                         subj=g.get("subj", "a player"))
    lines = [
        f"{m.get('playerName', '?')}: {str(m.get('message', ''))[:120]}"
        for m in transcript[-8:]
    ] or ["(no messages yet)"]
    return PROMPT_TEMPLATE.format(
        bot_name=plan.get("bot_name") or f"Player {bot}",
        game=game or snapshot.get("gameName") or "the game",
        persona_name=pname, tic_open=opens[0], tic_close=closes[0],
        phase=snapshot.get("current_phase_name") or "the game",
        alive=_alive_board(players) or "unknown",
        fallen_line=f"Out of the game: {fallen}.\n" if fallen else "",
        facts=_facts_board(players, bot, visibility or {}) or "none listed",
        board_line=f"Scoreboard: {board}.\n" if board else "",
        know_line=("What only you know: " + "; ".join(know) + ".\n"
                   if know else ""),
        grounded_block=gblock,
        transcript="\n".join(lines),
        sender_name=plan.get("sender_name") or "A player",
        text=str(plan.get("text", ""))[:200],
        max_chars=MAX_REPLY_CHARS,
    )


_NAME_PREFIX = re.compile(r"^\s*[\w .'-]{1,24}:\s+")
_FENCE = re.compile(r"```+[a-z]*", re.IGNORECASE)


def sanitize_reply(text: Optional[str]) -> str:
    """Model output -> one chat bubble. Strips code fences, a leading
    'Name: ' prefix and wrapping quotes, collapses all whitespace to
    single spaces, and truncates at the last sentence end under
    MAX_REPLY_CHARS. Returns '' for junk (caller falls through to the
    next tier)."""
    if not text:
        return ""
    s = _FENCE.sub(" ", str(text))
    s = " ".join(s.split())
    if not s:
        return ""
    m = _NAME_PREFIX.match(s)
    if m and len(s) > m.end():
        s = s[m.end():]
    if len(s) >= 2 and s[0] in "\"'“" and s[-1] in "\"'”":
        s = s[1:-1].strip()
    if len(s) > MAX_REPLY_CHARS:
        cut = s[:MAX_REPLY_CHARS]
        # prefer a sentence boundary, then a word boundary
        end = max(cut.rfind("."), cut.rfind("!"), cut.rfind("?"))
        s = cut[: end + 1] if end > 40 else cut[: cut.rfind(" ")].rstrip()
    return s.strip()


def make_chat_llm_hook(complete: Callable[[str], str]):
    """Wrap a completion function into the host's external chat tier:
    ``hook(prompt) -> Optional[str]`` — sanitized reply, or None on any
    failure/empty output (the caller falls through to the learned LM and
    template tiers; grounded verification happens in the caller so every
    tier shares one enforcement point)."""

    def hook(prompt: str) -> Optional[str]:
        out = sanitize_reply(complete(prompt))
        return out or None

    return hook
