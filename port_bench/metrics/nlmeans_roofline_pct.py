"""nlmeans_roofline_pct: the NLMeans stage's least time on the card
(``roofline/nlmeans.py`` against ``roofline/peaks.json``) over the
card-busy time inside its ranges, summed over the traced tiles."""


def read(run):
    busy = (run.trace or {}).get('stage_busy_s', {}).get('nlmeans')
    if not busy or 'nlmeans' not in run.stage_bound_s:
        return None
    return 100.0 * run.stage_bound_s['nlmeans'] / busy
