declare q3_date date default date '1995-03-15'
    in (date '1995-03-01', date '1995-03-31');
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from lineitem
    join orders on l_orderkey = o_orderkey
where o_orderdate < :q3_date
  and l_shipdate > :q3_date
  and o_custkey in (select c_custkey from customer
                    where c_mktsegment = 'BUILDING')
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
