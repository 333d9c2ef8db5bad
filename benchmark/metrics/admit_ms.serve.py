"""Mean host time of an admission (`engine.admit`: the language forward over
every slot and the row writes), ended by a sync, over the traced window."""


def read(record):
    spans = record.get("spans", {}).get("admit")
    return 1e3 * sum(spans) / len(spans) if spans else None
