"""Guard layer of the port: the failures that never raise.

- watchdog.DispatchWatchdog: every sweep and serve dispatch runs on a
  watched thread whose deadline comes from the scheduler's
  ``bucket_cost`` price; a hang surfaces ``DispatchStalled`` into the
  recovery path instead of stopping the run, and a recovery that finds
  the abandoned call still inside the engine after a grace raises
  ``EnginePoisoned`` instead of dispatching beside it;
- numerics.check_values / check_payload: the validation boundary at
  score-extraction time, quarantining rows as ``error:numerics``.
"""
