"""Corpora, one module each, found by the name a configuration gives under
"corpus" (vsbench/corpora/<corpus>.py).

A corpus module makes, from the run's seed and the configuration and
traffic objects, the items the system loads and the query pool its clients
draw from.  It has

    for_driver(config, traffic, seed, device) -> (items, pool)
                        the items in the form the configuration's driver
                        loads (`System.start(items)`; `len(items)` is the
                        number of items every answer's keys are held to)
                        and the pool, whose entries `System.ask` takes
    for_reference(config, traffic, seed, device) -> (items, pool)
                        the same items and queries again, in the form the
                        configuration's reference takes

Both sides are made from the seed alone, so the reference reads nothing the
program made.  A corpus imports torch and numpy alone.
"""
