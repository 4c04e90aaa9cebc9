with ps as (
    select ps_partkey, ps_supplycost * ps_availqty as value
    from partsupp
    where ps_suppkey in (select s_suppkey from supplier
                         where s_nationkey = code('n_name', 'GERMANY'))
)
select ps_partkey, sum(value) as value
from ps
group by ps_partkey
having sum(value) > (select sum(value) from ps) * (0.0001 / dbscale())
       /*+ shrink(1048576) */
order by value desc
