"""Share of the prompt tokens admitted in the window that the radix prefix
cache served (``ServingEngine.stats()``, the window's deltas)."""


def read(run):
    s0, s1 = run.window.stats0, run.window.stats1
    prompt = s1["prompt_tokens"] - s0["prompt_tokens"]
    if "prefix_hit_tokens" not in s1 or prompt <= 0:
        return None
    return 100.0 * (s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"]) / prompt
